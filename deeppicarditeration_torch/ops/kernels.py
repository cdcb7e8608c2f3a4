"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Counterpart of ``deeppicarditeration_tpu/ops/pallas_kernels.py``. Ported so
far: the merged terminal + integral estimator kernel (``_generate_kernel``
there, ``csrc/generate.cu`` here).

Build: at first use, ``nvcc`` compiles each ``csrc/*.cu`` source for
``sm_90a`` into a shared library with a plain C interface under
``build/kernels/`` (named by a hash of source and flags), loaded with
ctypes. Nothing is downloaded; a missing ``nvcc`` or a failed build raises.

Each wrapper takes the plain PyTorch version for tensors on the CPU, and
for CUDA tensors launches its kernel or raises: there is no fallback. Each
library object counts its launches in ``launches`` (a plain integer that
only the launch site increments).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import torch

from deeppicarditeration_torch.equations.burgers import Cha
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import VALUE, Solution
from deeppicarditeration_torch.ops.derivatives import get_f

CSRC_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory one block may use on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 232448


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "port's CUDA kernels are built from csrc/ at first use")
    return path


class CudaLibrary:
    """One ``csrc`` source, built at first use and loaded with ctypes."""

    def __init__(self, source: str):
        self.source = CSRC_DIR / source
        self.launches = 0
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None

    @property
    def so_path(self) -> pathlib.Path:
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{h}.so"

    def _build(self) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {self.source.name} (exit "
                f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, self.so_path)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first unless its .so exists."""
        if self._lib is None:
            if not self.so_path.exists():
                self._build()
            self._lib = ctypes.CDLL(str(self.so_path))
            _declare(self._lib)
        return self._lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dpi_generate.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_ulonglong] \
        + [f] * 4 + [p]
    lib.dpi_generate.restype = i
    lib.dpi_generate_hidden_width.argtypes = []
    lib.dpi_generate_hidden_width.restype = i
    lib.dpi_generate_max_nx.argtypes = []
    lib.dpi_generate_max_nx.restype = i
    lib.dpi_generate_smem_bytes.argtypes = [i, i]
    lib.dpi_generate_smem_bytes.restype = ctypes.c_longlong


GENERATE = CudaLibrary("generate.cu")


# ---------------------------------------------------------------------------
# merged terminal + integral estimator (TPU: _generate_kernel)
# ---------------------------------------------------------------------------

def _largest_divisor(n: int, cap: int) -> int:
    d = max(1, min(n, cap))
    while n % d:
        d -= 1
    return d


def generate_with_gradients_plain(seed: int, eq, sol: Solution,
                                  tx: torch.Tensor, m: int,
                                  u01: Optional[torch.Tensor] = None,
                                  noise_t: Optional[torch.Tensor] = None,
                                  noise_i: Optional[torch.Tensor] = None, *,
                                  chunk_rows: int = 2 ** 16,
                                  return_var: bool = False):
    """Plain PyTorch version of the merged estimator kernel.

    Same signature and meaning as ``generate_with_gradients_cuda``: with
    external ``u01`` (B, m, 1), ``noise_t`` and ``noise_i`` (B, m, nx) it
    uses them, else it draws them chunk by chunk from a torch.Generator
    seeded with ``seed``. Chunked over m so that at most ``chunk_rows``
    samples pass through the frozen net at once. ``return_var`` also
    returns the per-point sample variance of each of the 1 + nx summands
    (for CLT bounds)."""
    from deeppicarditeration_torch.ops.estimators import _ST_FLOOR

    t, x = tx[:, :1], tx[:, 1:]
    b, nx = x.shape
    a = eq.alpha_sqrt
    external = noise_t is not None
    gen = None
    if not external:
        gen = torch.Generator(device=tx.device)
        gen.manual_seed(int(seed))
    Tt = torch.clamp(eq.T - t, min=1e-6)
    sqrt_Tt = torch.sqrt(Tt)
    inv_yT = 1.0 / (sqrt_Tt * a)
    g0 = eq.g(x)
    f0 = get_f(eq, sol, t, x)
    mc = _largest_divisor(m, max(1, chunk_rows // b))
    s1 = tx.new_zeros((b, 1 + nx))
    s2 = tx.new_zeros((b, 1 + nx)) if return_var else None
    kw = dict(dtype=tx.dtype, device=tx.device, generator=gen)
    for c0 in range(0, m, mc):
        if external:
            u = u01[:, c0:c0 + mc]
            dWt = noise_t[:, c0:c0 + mc]
            dWi = noise_i[:, c0:c0 + mc]
        else:
            u = torch.rand((b, mc, 1), **kw)
            dWt = torch.randn((b, mc, nx), **kw)
            dWi = torch.randn((b, mc, nx), **kw)
        xT = x[:, None, :] + sqrt_Tt[:, None, :] * a * dWt
        diff_t = eq.g(xT) - g0[:, None, :]
        s = t[:, None, :] + u * Tt[:, None, :]
        st = s - t[:, None, :]
        xs = x[:, None, :] + torch.sqrt(st) * a * dWi
        f = get_f(eq, sol, s.reshape(-1, 1), xs.reshape(-1, nx))
        diff_i = Tt[:, None, :] * (f.reshape(b, mc, 1) - f0[:, None, :])
        inv_ys = 1.0 / (torch.sqrt(torch.clamp(st, min=_ST_FLOOR)) * a)
        z = torch.cat([diff_t + diff_i,
                       diff_t * dWt * inv_yT[:, None, :]
                       + diff_i * inv_ys * dWi], dim=-1)
        s1 += z.sum(dim=1)
        if return_var:
            s2 += (z * z).sum(dim=1)
    mean = s1 / m
    out = mean.clone()
    out[:, 0:1] += g0 + f0 * Tt
    if return_var:
        return out, torch.clamp(s2 / m - mean * mean, min=0.0)
    return out


def kernel_net(sol: Solution, nx: int, width: int = 128) -> Optional[MLP]:
    """The MLP the kernel runs for ``sol`` (None for the zero iterate).
    Raises for a frozen iterate the kernel does not cover (``width``: the
    hidden width the kernel is compiled for)."""
    if sol.kind == "zero":
        return None
    mod = sol.module
    if not (sol.kind == "net" and sol.net_type == VALUE
            and isinstance(mod, MLP)):
        raise NotImplementedError(
            "the CUDA estimator kernel covers the zero iterate and Value "
            f"MLPs only (got kind={sol.kind!r}, net_type={sol.net_type!r}, "
            f"module={type(mod).__name__})")
    if (mod.out_dim != 1 or mod.bound is not None
            or any(a != "ELU" for a in mod.activations)
            or any(n != width for n in mod.neurons)
            or mod.layers[0].in_features != 1 + nx):
        raise NotImplementedError(
            f"the CUDA estimator kernel covers ELU MLPs of hidden width "
            f"{width} with one unclamped output (got neurons "
            f"{mod.neurons}, activations {mod.activations}, bound "
            f"{mod.bound}, out_dim {mod.out_dim})")
    if any(p.dtype != torch.float32 for p in mod.parameters()):
        raise NotImplementedError("the CUDA estimator kernel is f32 only")
    return mod


def pack_mlp(mod: MLP) -> torch.Tensor:
    """The kernel's packed weight buffer: W1^T, b1, then per hidden layer
    l >= 2: W_l^T, W_l, b_l, then the head's weight row and bias."""
    lin = list(mod.layers)
    parts = [lin[0].weight.t(), lin[0].bias]
    for layer in lin[1:-1]:
        parts += [layer.weight.t(), layer.weight, layer.bias]
    parts += [lin[-1].weight.reshape(-1), lin[-1].bias]
    return torch.cat([p.detach().contiguous().reshape(-1) for p in parts])


def _check(name: str, v: torch.Tensor, shape, device) -> None:
    if v.device != device or v.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{v.dtype} on {v.device}")
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def generate_with_gradients_cuda(seed: int, eq, sol: Solution,
                                 tx: torch.Tensor, m: int,
                                 u01: Optional[torch.Tensor] = None,
                                 noise_t: Optional[torch.Tensor] = None,
                                 noise_i: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Merged terminal + integral estimator, (B, 1 + nx) f32.

    ``m`` is the shared per-point sample count of both chains. Without
    external noise the kernel draws its own normals (Philox4x32-10 keyed by
    (seed, point)); with ``u01`` (B, m, 1) and ``noise_t``/``noise_i``
    (B, m, nx) it uses those, as the TPU kernel does (its test path). CPU
    tensors take ``generate_with_gradients_plain``."""
    if tx.device.type == "cpu":
        return generate_with_gradients_plain(seed, eq, sol, tx, m, u01,
                                             noise_t, noise_i)
    if tx.device.type != "cuda":
        raise ValueError(f"unsupported device {tx.device}")
    if not isinstance(eq, Cha):
        raise NotImplementedError(
            f"the CUDA estimator kernel covers the Cha equation only (got "
            f"{type(eq).__name__}); other equations come in later slices")
    b, nx = tx.shape[0], tx.shape[1] - 1
    _check("tx", tx, (b, 1 + nx), tx.device)
    ext = [v is not None for v in (u01, noise_t, noise_i)]
    if any(ext) and not all(ext):
        raise ValueError("external noise needs all of u01, noise_t, noise_i")
    if all(ext):
        _check("u01", u01, (b, m, 1), tx.device)
        _check("noise_t", noise_t, (b, m, nx), tx.device)
        _check("noise_i", noise_i, (b, m, nx), tx.device)
    lib = GENERATE.lib()
    if nx > lib.dpi_generate_max_nx():
        raise NotImplementedError(
            f"nx={nx} exceeds the kernel's {lib.dpi_generate_max_nx()}")
    mod = kernel_net(sol, nx, lib.dpi_generate_hidden_width())
    n_hidden = len(mod.neurons) if mod is not None else 0
    smem = lib.dpi_generate_smem_bytes(nx, n_hidden)
    if smem > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"the kernel needs {smem} B of shared memory at nx={nx}, "
            f"{n_hidden} hidden layers (at most {MAX_SMEM_BYTES})")
    if mod is not None and next(mod.parameters()).device != tx.device:
        raise ValueError("the frozen net must lie on the device of tx")
    t = tx[:, :1].contiguous()
    x = tx[:, 1:].contiguous()
    g0 = eq.g(x).contiguous()
    f0 = get_f(eq, sol, t, x).contiguous()
    w = pack_mlp(mod) if mod is not None else None
    out = torch.empty((b, 1 + nx), dtype=torch.float32, device=tx.device)
    ptr = (lambda v: v.data_ptr() if v is not None else None)
    stream = torch.cuda.current_stream(tx.device).cuda_stream
    rc = lib.dpi_generate(
        ptr(t), ptr(x), ptr(g0), ptr(f0), ptr(w), ptr(u01), ptr(noise_t),
        ptr(noise_i), ptr(out), b, int(m), nx, n_hidden,
        int(mod is not None), int(seed) & 0xFFFFFFFFFFFFFFFF,
        float(eq.T), float(eq.alpha_sqrt), float(eq.k),
        float(eq.ff_offset), stream)
    if rc != 0:
        raise RuntimeError(f"dpi_generate launch failed: CUDA error {rc}")
    GENERATE.launches += 1
    return out


def generate_flops_per_sample(nx: int, neurons) -> int:
    """FP32 operations (2 per multiply-add) the kernel's frozen-net pass
    needs per sample: forward [s, X_s] -> u, backward to the first layer's
    pre-activation gradient, and its contraction with W1's column sums."""
    widths = [1 + nx] + list(neurons) + [1]
    fwd = sum(a * b for a, b in zip(widths, widths[1:]))
    hidden = list(neurons)
    bwd = hidden[-1] + sum(a * b for a, b in zip(hidden, hidden[1:])) \
        + hidden[0]
    return 2 * (fwd + bwd)

