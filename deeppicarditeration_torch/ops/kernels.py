"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Counterpart of ``deeppicarditeration_tpu/ops/pallas_kernels.py``. Ported so
far, each from its TPU kernel there (the last two from
``deeppicarditeration_tpu/ops/rollout.py`` and
``scripts/probe_vpu_roofline.py``):

==========================  ====================  ==========================
wrapper                     source                TPU kernel
==========================  ====================  ==========================
generate_with_gradients     csrc/generate.cu      _generate_kernel (merged)
generate_pis                csrc/generate_pis.cu  _generate_kernel (merged),
                                                  its OU + PISGradNet instance
terminal_with_gradients     csrc/terminal.cu      _terminal_kernel
integral_with_gradients     csrc/integral.cu      _integral_kernel
normals                     csrc/normals.cu       _normals_kernel
paths                       csrc/rollout.cu       _paths_kernel
probe                       csrc/probe.cu         _probe_kernel
==========================  ====================  ==========================

Shared device code: ``csrc/philox.cuh`` (Philox4x32-10, Box-Muller),
``csrc/draws.cuh`` (its fast draws), ``csrc/value_mlp.cuh`` (the frozen
value net's forward and backward pass in FP32 FMA), ``csrc/value_mlp_tc.cuh``
(the same pass on the tensor cores, and the block layout around it) and
``csrc/gmm.cuh`` (the OU equation's mixture terminal).

Precision (``DATA.TPU.PALLAS_PRECISION``, the TPU kernels'
``mxu_precision``) of the frozen-net dots in the merged and the integral
estimator: ``"bf16x3"`` splits each f32 operand into a bf16 hi part and a
bf16-rounded residual lo and sums hi*hi + lo*hi + hi*lo (``_split3`` in the
JAX package; the kernels run it on the tensor cores with ``wgmma``),
``"default"`` is the single hi*hi pass, ``"highest"`` full f32: the merged
kernel's FP32-FMA pass, the integral kernel's six bf16 passes over three
pieces of each operand (``six_pass_dot``), the MXU's f32 product. The plain
versions compute the same products (``precision_dot``; "highest" the f32
matmul).

Build: at first use, ``nvcc`` compiles each ``csrc/*.cu`` source for
``sm_90a`` into a shared library with a plain C interface under
``build/kernels/`` (named by a hash of source, headers and flags), loaded
with ctypes; ``build`` compiles several at once. Nothing is downloaded; a
missing ``nvcc`` or a failed build raises.

Each wrapper (``*_cuda``) takes the plain PyTorch version (``*_plain``, same
signature) for tensors on the CPU, and for CUDA tensors launches its kernel
or raises: there is no fallback. Each library object counts its launches in
``launches`` (a plain integer that only the launch site increments). A
wrapper called while its stream captures a CUDA graph launches nothing, so
it counts nothing; the graph's replays run no wrapper. Launches inside
replays are read from a torch.profiler trace.
"""

from __future__ import annotations

import ctypes
import math
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from deeppicarditeration_torch.equations.burgers import Cha
from deeppicarditeration_torch.equations.hjb import OUProcessEquation
from deeppicarditeration_torch.models.networks import MLP, PISGradNet
from deeppicarditeration_torch.models.solution import VALUE, Solution
from deeppicarditeration_torch.ops.derivatives import get_f

CSRC_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory one block may use on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 232448
# Hidden width the net kernels are compiled for (value_mlp.cuh: H)
KERNEL_WIDTH = 128


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "port's CUDA kernels are built from csrc/ at first use")
    return path


class CudaLibrary:
    """One ``csrc`` source, built at first use and loaded with ctypes;
    ``declare`` sets the C entry points' argument types."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = CSRC_DIR / source
        self.declare = declare
        self.launches = 0
        # launches by precision mode (the net kernels' FP32-FMA and
        # tensor-core kernels), counted at the same launch site
        self.mode_launches: dict = {}
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None

    @property
    def so_path(self) -> pathlib.Path:
        # the headers beside the source: a variant's own (the benches')
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def _start_build(self):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def _finish_build(self, job) -> None:
        proc, tmp, t0 = job
        self.build_log = proc.communicate()[0]
        self.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {self.source.name} (exit "
                f"{proc.returncode}):\n{self.build_log}")
        os.replace(tmp, self.so_path)

    def count(self, mode: Optional[str] = None) -> None:
        """One launch (of the kernel for ``mode``); nothing while the
        current stream captures a graph (the call only records the
        kernel)."""
        if torch.cuda.is_current_stream_capturing():
            return
        self.launches += 1
        if mode is not None:
            self.mode_launches[mode] = self.mode_launches.get(mode, 0) + 1

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first unless its .so exists."""
        if self._lib is None:
            if not self.so_path.exists():
                self._finish_build(self._start_build())
            self._lib = ctypes.CDLL(str(self.so_path))
            self.declare(self._lib)
        return self._lib


def build(*libs: CudaLibrary) -> None:
    """Build the libraries that are not built yet, one nvcc each, all
    started together; then load them. Raises on the first failed build
    after every nvcc has ended."""
    jobs = [(lib, lib._start_build()) for lib in libs
            if lib._lib is None and not lib.so_path.exists()]
    errors = []
    for lib, job in jobs:
        try:
            lib._finish_build(job)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    for lib in libs:
        lib.lib()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U64, _I64 = ctypes.c_ulonglong, ctypes.c_longlong


def _declare_net_limits(lib: ctypes.CDLL, name: str) -> None:
    getattr(lib, f"dpi_{name}_hidden_width").argtypes = []
    getattr(lib, f"dpi_{name}_hidden_width").restype = _I
    getattr(lib, f"dpi_{name}_max_nx").argtypes = []
    getattr(lib, f"dpi_{name}_max_nx").restype = _I
    getattr(lib, f"dpi_{name}_smem_bytes").argtypes = [_I, _I]
    getattr(lib, f"dpi_{name}_smem_bytes").restype = _I64


def _declare_generate(lib: ctypes.CDLL) -> None:
    lib.dpi_generate.argtypes = [_P] * 9 + [_I] * 6 + [_U64] + [_F] * 4 \
        + [_P]
    lib.dpi_generate.restype = _I
    _declare_net_limits(lib, "generate")
    lib.dpi_generate_tc_w.argtypes = [_P] * 11 + [_I] * 8 + [_U64] \
        + [_F] * 4 + [_P]
    lib.dpi_generate_tc_w.restype = _I
    lib.dpi_generate_tc_scratch_bytes_w.argtypes = [_I] * 3
    lib.dpi_generate_tc_scratch_bytes_w.restype = _I64
    lib.dpi_generate_tc_plan_w.argtypes = [_I, _I, _I, _P]
    lib.dpi_generate_tc_plan_w.restype = None
    lib.dpi_generate_tc_max_nx.argtypes = []
    lib.dpi_generate_tc_max_nx.restype = _I
    lib.dpi_generate_tc_widths.argtypes = [_P]
    lib.dpi_generate_tc_widths.restype = _I


def _declare_terminal(lib: ctypes.CDLL) -> None:
    lib.dpi_terminal.argtypes = [_P] * 5 + [_I] * 4 + [_U64] + [_F] * 3 \
        + [_P]
    lib.dpi_terminal.restype = _I
    lib.dpi_terminal_max_nx.argtypes = []
    lib.dpi_terminal_max_nx.restype = _I
    lib.dpi_terminal_smem_bytes.argtypes = [_I]
    lib.dpi_terminal_smem_bytes.restype = _I64
    lib.dpi_terminal_check_draws.argtypes = [_P, _P]
    lib.dpi_terminal_check_draws.restype = _I


def _declare_integral(lib: ctypes.CDLL) -> None:
    for name in ("hidden_width", "max_nx"):
        fn = getattr(lib, f"dpi_integral_{name}")
        fn.argtypes = []
        fn.restype = _I
    _declare_tc(lib, "integral", 9)
    if hasattr(lib, "dpi_integral_tc_plan"):
        lib.dpi_integral_tc_plan.argtypes = [_I, _I, _I, _P]
        lib.dpi_integral_tc_plan.restype = None


def _declare_tc(lib: ctypes.CDLL, name: str, n_ptr: int) -> None:
    """The tensor-core entry point ``dpi_{name}_tc`` (``n_ptr`` pointers,
    then B, M, nx, L, has_net, anti, mode, the seed, T, alpha_sqrt, k, c0
    and the stream) and its scratch query (nx, L)."""
    fn = getattr(lib, f"dpi_{name}_tc")
    fn.argtypes = [_P] * n_ptr + [_I] * 7 + [_U64] + [_F] * 4 + [_P]
    fn.restype = _I
    q = getattr(lib, f"dpi_{name}_tc_scratch_bytes")
    q.argtypes = [_I, _I]
    q.restype = _I64


def _declare_normals(lib: ctypes.CDLL) -> None:
    lib.dpi_normals.argtypes = [_P, _I64, _U64, _P]
    lib.dpi_normals.restype = _I


def _declare_rollout(lib: ctypes.CDLL) -> None:
    lib.dpi_paths.argtypes = [_P] * 4 + [_I] * 3 + [_U64, _P, _P, _I64, _F,
                                                     _P]
    lib.dpi_paths.restype = _I
    lib.dpi_paths_smem_bytes.argtypes = [_I]
    lib.dpi_paths_smem_bytes.restype = _I64


def _declare_probe(lib: ctypes.CDLL) -> None:
    lib.dpi_probe.argtypes = [_P, _I, _I, _I, _U64, _P]
    lib.dpi_probe.restype = _I
    lib.dpi_probe_grid.argtypes = [_I]
    lib.dpi_probe_grid.restype = _I


def _declare_generate_pis(lib: ctypes.CDLL) -> None:
    lib.dpi_generate_pis.argtypes = [_P] * 12 + [_I] * 8 + [_U64] \
        + [_F] * 7 + [_P]
    lib.dpi_generate_pis.restype = _I
    for name in ("hidden_width", "channels", "max_nx", "max_components"):
        fn = getattr(lib, f"dpi_generate_pis_{name}")
        fn.argtypes = []
        fn.restype = _I
    lib.dpi_generate_pis_image_elems.argtypes = [_I, _I]
    lib.dpi_generate_pis_image_elems.restype = _I64
    lib.dpi_generate_pis_vec_floats.argtypes = [_I, _I]
    lib.dpi_generate_pis_vec_floats.restype = _I
    lib.dpi_generate_pis_smem_bytes.argtypes = [_I] * 4
    lib.dpi_generate_pis_smem_bytes.restype = _I64
    lib.dpi_generate_pis_grid.argtypes = [_I] * 5
    lib.dpi_generate_pis_grid.restype = _I
    lib.dpi_generate_pis_scratch_floats_nx.argtypes = [_I] * 4
    lib.dpi_generate_pis_scratch_floats_nx.restype = _I64
    if hasattr(lib, "dpi_generate_pis_plan"):
        lib.dpi_generate_pis_plan.argtypes = [_I] * 5 + [_P]
        lib.dpi_generate_pis_plan.restype = None


GENERATE = CudaLibrary("generate.cu", _declare_generate)
GENERATE_PIS = CudaLibrary("generate_pis.cu", _declare_generate_pis)
TERMINAL = CudaLibrary("terminal.cu", _declare_terminal)
INTEGRAL = CudaLibrary("integral.cu", _declare_integral)
NORMALS = CudaLibrary("normals.cu", _declare_normals)
ROLLOUT = CudaLibrary("rollout.cu", _declare_rollout)
PROBE = CudaLibrary("probe.cu", _declare_probe)
ALL = (GENERATE, GENERATE_PIS, TERMINAL, INTEGRAL, NORMALS, ROLLOUT, PROBE)
# the rollout's kernel function in csrc/rollout.cu, as a trace names it
ROLLOUT_KERNEL = "paths_kernel"


def trace_launches(prof, kernel: str) -> int:
    """Launches of the kernels whose name contains ``kernel`` in a
    finished ``torch.profiler.profile`` with CUDA activity: its device
    events, eager launches and those inside graph replays alike."""
    from torch.autograd import DeviceType

    return sum(1 for ev in prof.events()
               if ev.device_type == DeviceType.CUDA and kernel in ev.name)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def draw_rows(m: int, antithetic: bool) -> int:
    """Rows of draws an estimator of ``m`` samples takes: m, or m / 2 with
    antithetic pairing (which needs an even m)."""
    if antithetic and m % 2:
        raise ValueError(
            f"antithetic pairing needs an even sample count (got {m})")
    return m // 2 if antithetic else m


def _draw_chunks(seed: int, tx: torch.Tensor, m: int, antithetic: bool,
                 chunk_rows: int, spec, external: Optional[dict]):
    """The plain versions' randomness, chunk by chunk over the samples.

    ``spec``: (name, width, "u" | "n") per input. Yields dicts of
    (B, mc, width) tensors: slices of the ``external`` arrays (B, rows,
    width), or draws from a torch.Generator seeded with ``seed``. With
    ``antithetic`` each chunk holds its draw rows followed by their mirrors
    (normals negated, uniforms repeated)."""
    from deeppicarditeration_torch.ops.estimators import largest_divisor

    b = tx.shape[0]
    rows = draw_rows(m, antithetic)
    gen = None
    if external is None:
        gen = torch.Generator(device=tx.device)
        gen.manual_seed(int(seed))
    per = 2 if antithetic else 1
    mc = largest_divisor(rows, chunk_rows // (b * per))
    kw = dict(dtype=tx.dtype, device=tx.device, generator=gen)
    for c0 in range(0, rows, mc):
        chunk = {}
        for name, width, kind in spec:
            if external is not None:
                v = external[name][:, c0:c0 + mc]
            elif kind == "u":
                v = torch.rand((b, mc, width), **kw)
            else:
                v = torch.randn((b, mc, width), **kw)
            if antithetic:
                v = torch.cat([v, v if kind == "u" else -v], dim=1)
            chunk[name] = v
        yield chunk


def _accumulate(chunks_z, b: int, d: int, m: int, antithetic: bool,
                like: torch.Tensor, return_var: bool):
    """Mean over the m samples of the (B, mc, d) summands ``chunks_z``;
    with ``return_var`` also the variance v of one summand such that the
    mean's standard error is sqrt(v / m) (antithetic: twice the variance of
    a pair's average, as the pairs are the independent draws)."""
    s1 = like.new_zeros((b, d))
    s2 = like.new_zeros((b, d)) if return_var else None
    for z in chunks_z:
        s1 += z.sum(dim=1)
        if return_var:
            if antithetic:
                h = z.shape[1] // 2
                z = 0.5 * (z[:, :h] + z[:, h:])
            s2 += (z * z).sum(dim=1)
    mean = s1 / m
    if not return_var:
        return mean, None
    n = m // 2 if antithetic else m
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return mean, (2.0 * var if antithetic else var)


def _terminal_z(eq, x, sqrt_Tt, g0, inv_y, dW):
    """Terminal summands (B, mc, 1 + nx): (g(X_T) - g0) (1, dW inv_y)."""
    xT = x[:, None, :] + sqrt_Tt[:, None, :] * eq.alpha_sqrt * dW
    diff = eq.g(xT) - g0[:, None, :]
    return torch.cat([diff, diff * dW * inv_y[:, None, :]], dim=-1)


def _integral_z(eq, sol, t, x, Tt, f0, u, dW):
    """Integral summands (B, mc, 1 + nx): Tt (f - f0) (1, dW / ys)."""
    from deeppicarditeration_torch.ops.estimators import _ST_FLOOR

    b, mc, nx = dW.shape
    s = t[:, None, :] + u * Tt[:, None, :]
    st = s - t[:, None, :]
    xs = x[:, None, :] + torch.sqrt(st) * eq.alpha_sqrt * dW
    f = get_f(eq, sol, s.reshape(-1, 1), xs.reshape(-1, nx))
    diff = Tt[:, None, :] * (f.reshape(b, mc, 1) - f0[:, None, :])
    inv_ys = 1.0 / (torch.sqrt(torch.clamp(st, min=_ST_FLOOR))
                    * eq.alpha_sqrt)
    return torch.cat([diff, diff * inv_ys * dW], dim=-1)


def _with_value_offset(mean: torch.Tensor, offset: torch.Tensor):
    out = mean.clone()
    out[:, 0:1] += offset
    return out


def _check(name: str, v: torch.Tensor, shape, device) -> None:
    if v.device != device or v.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{v.dtype} on {v.device}")
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_card(name: str, tx: torch.Tensor, eq, covers=Cha) -> None:
    """Checks every CUDA wrapper makes before it launches: a CUDA tensor
    and the equation class the kernel is specialised to."""
    if tx.device.type != "cuda":
        raise ValueError(f"unsupported device {tx.device}")
    if not isinstance(eq, covers):
        raise NotImplementedError(
            f"the CUDA {name} kernel covers the {covers.__name__} equation "
            f"only (got {type(eq).__name__})")


def _ptr(v: Optional[torch.Tensor]):
    return v.data_ptr() if v is not None else None


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _seed(seed: int) -> int:
    return int(seed) & 0xFFFFFFFFFFFFFFFF


def kernel_net(sol: Solution, nx: int, width=KERNEL_WIDTH
               ) -> Optional[MLP]:
    """The MLP the net kernels run for ``sol`` (None for the zero iterate).
    Raises for a frozen iterate they do not cover (``width``: the hidden
    width they are compiled for, or a tuple of widths: every hidden layer
    of one and the same of them; unequal widths, other activations, an
    output bound or more than one output raise)."""
    widths = (width,) if isinstance(width, int) else tuple(width)
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
            or len(set(mod.neurons)) != 1 or mod.neurons[0] not in widths
            or mod.layers[0].in_features != 1 + nx):
        *head, last = map(str, widths)
        shown = f"{', '.join(head)} or {last}" if head else last
        raise NotImplementedError(
            f"the CUDA estimator kernel covers ELU MLPs whose hidden layers "
            f"are all of width {shown}, with one unclamped output (got neurons "
            f"{mod.neurons}, activations {mod.activations}, bound "
            f"{mod.bound}, out_dim {mod.out_dim})")
    if any(p.dtype != torch.float32 for p in mod.parameters()):
        raise NotImplementedError("the CUDA estimator kernel is f32 only")
    return mod


# The merged kernel's cover (csrc/generate.cu), held equal to the built
# library's by the card tests: the tensor-core kernel ("bf16x3",
# "default"; dpi_generate_tc_widths, dpi_generate_tc_max_nx: widths 64
# and 128, and 256 to 1024 in steps of 128, the wide pass) and the
# FP32-FMA kernel ("highest"; dpi_generate_hidden_width,
# dpi_generate_max_nx)
GENERATE_TC_WIDTHS = (64, 128) + tuple(range(256, 1025, 128))
GENERATE_TC_MAX_NX = 1024
# capacity of the buffer dpi_generate_tc_widths fills
TC_WIDTHS_CAP = 16
GENERATE_FMA_WIDTH, GENERATE_FMA_MAX_NX = KERNEL_WIDTH, 511


def merged_covers(eq, sol: Solution, precision: str):
    """None where the merged kernel (``generate.cu``) covers (eq, sol) in
    ``precision``, else why not: decided from the structure alone (the
    equation, nx against the limit of the precision's kernel, the net's
    kind, widths, activations and depth), before any launch. Antithetic
    pairing is covered wherever the kernel is, so it takes no part; the
    counterpart of ``pis_covers`` for the Burgers equation."""
    if not isinstance(eq, Cha):
        return f"it covers the Cha equation, not {type(eq).__name__}"
    highest = check_precision(precision) == "highest"
    limit = GENERATE_FMA_MAX_NX if highest else GENERATE_TC_MAX_NX
    if eq.nx > limit:
        return f"nx={eq.nx} exceeds its {limit} in {precision!r}"
    try:
        kernel_net(sol, eq.nx, (GENERATE_FMA_WIDTH,) if highest
                   else GENERATE_TC_WIDTHS)
    except NotImplementedError as e:
        return f"{e} in {precision!r}"
    return None


def pack_mlp(mod: MLP) -> torch.Tensor:
    """The kernel's packed weight buffer: W1^T, b1, then per hidden layer
    l >= 2: W_l^T, W_l, b_l, then the head's weight row and bias."""
    lin = list(mod.layers)
    parts = [lin[0].weight.t(), lin[0].bias]
    for layer in lin[1:-1]:
        parts += [layer.weight.t(), layer.weight, layer.bias]
    parts += [lin[-1].weight.reshape(-1), lin[-1].bias]
    return torch.cat([p.detach().contiguous().reshape(-1) for p in parts])


# ---------------------------------------------------------------------------
# precision of the frozen-net dots (DATA.TPU.PALLAS_PRECISION)
# ---------------------------------------------------------------------------

PRECISIONS = ("bf16x3", "highest", "default")
# the tensor-core kernels' mode argument (the integral kernel's also
# "highest": six passes)
_TC_MODES = {"bf16x3": 1, "default": 2}
_INTEGRAL_MODES = {**_TC_MODES, "highest": 3}
# K-extent of the tensor-core pass's weight slabs (value_mlp_tc.cuh: SLAB_K)
TC_SLAB_K = 64


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"pallas_precision must be one of {PRECISIONS} "
                         f"(got {precision!r})")
    return precision


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """a rounded to bf16 (to nearest even) and back to f32."""
    return a.to(torch.bfloat16).to(a.dtype)


def _dot_at(a: torch.Tensor, b: torch.Tensor, precision: str):
    """a @ b in ``precision``: "bf16x3" is ``_split3`` (hi = bf16(a),
    lo = bf16(a - hi); hi*hi + lo*hi + hi*lo, the lo*lo term dropped),
    "default" the hi*hi pass. Each product is an f32 matmul of bf16-exact
    operands, so every product is exact and only the order of the f32 sums
    differs from the tensor cores'."""
    a_hi, b_hi = _bf16(a), _bf16(b)
    if precision == "default":
        return a_hi @ b_hi
    return a_hi @ b_hi + _bf16(a - a_hi) @ b_hi + a_hi @ _bf16(b - b_hi)


class _PrecisionDot(torch.autograd.Function):
    """a (..., K) @ b (K, N) in a bf16 mode, with the backward of the JAX
    package's ``_bf16x3_bwd`` (its 1-pass analogue for "default"):
    da = dot(g, b^T), db = dot(a^T, g) over the flattened leading dims."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return _dot_at(a, b, precision)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _dot_at(g, b.t(), ctx.precision)
        if ctx.needs_input_grad[1]:
            db = _dot_at(a.reshape(-1, a.shape[-1]).t(),
                         g.reshape(-1, g.shape[-1]), ctx.precision)
        return da, db, None


def bf16_pieces(a: torch.Tensor, n: int) -> list:
    """a as n bf16 pieces (f32 tensors): a0 = bf16(a), a1 = bf16(a - a0),
    a2 = bf16(a - a0 - a1); each residual is exact in f32."""
    out, r = [], a
    for _ in range(n):
        out.append(_bf16(r))
        r = r - out[-1]
    return out


def six_pass_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the integral kernel's "highest" computes it on the tensor
    cores (the MXU's six-pass f32 product): three bf16 pieces of each
    operand, a0 b0 + a0 b1 + a1 b0 + a0 b2 + a1 b1 + a2 b0, each product of
    bf16-exact operands, summed in f32. An emulation for the tests: the
    plain versions compute "highest" as the f32 matmul."""
    a0, a1, a2 = bf16_pieces(a, 3)
    b0, b1, b2 = bf16_pieces(b, 3)
    return (a0 @ b0 + a0 @ b1 + a1 @ b0 + a0 @ b2 + a1 @ b1 + a2 @ b0)


def precision_dot(a: torch.Tensor, b: torch.Tensor,
                  precision: str) -> torch.Tensor:
    """The dense contraction a (..., K) @ b (K, N) in ``precision``
    (``PRECISIONS``); "highest" is the plain f32 matmul."""
    if check_precision(precision) == "highest":
        return a @ b
    return _PrecisionDot.apply(a, b, precision)


class _AtPrecision(nn.Module):
    """An MLP or a PISGradNet whose dots (every Dense of it) run in
    ``precision`` (the JAX package's swap of the module's
    ``dot_general``, ``pallas_kernels._sol_statics``)."""

    def __init__(self, mod: nn.Module, precision: str):
        super().__init__()
        self.mod = mod
        self.precision = precision

    def forward(self, tx):
        return self.mod(tx, dot=lambda a, b: precision_dot(a, b,
                                                           self.precision))


def with_precision(sol: Solution, precision: str) -> Solution:
    """``sol`` with its MLP's or PISGradNet's dots in ``precision``; the
    zero iterate, other modules (which have no such knob in the JAX
    package either) and "highest" are returned as they are."""
    if (check_precision(precision) == "highest" or sol.kind != "net"
            or not isinstance(sol.module, (MLP, PISGradNet))):
        return sol
    return Solution.from_net(_AtPrecision(sol.module, precision),
                             sol.net_type, sol.nx)


def _core_tiles(w: torch.Tensor) -> torch.Tensor:
    """(out, in) -> the tensor-core pass's image: 8 x 8 core matrices
    (8 rows of out, 16 bytes of in each), core (i, j) at (i * in / 8 + j)
    * 64 elements, flattened."""
    n, k = w.shape
    return w.reshape(n // 8, 8, k // 8, 8).permute(0, 2, 1, 3).reshape(-1)


def tc_k1(nx: int) -> int:
    """Layer 1's K in the tensor-core pass: 1 + nx padded to whole slabs."""
    return -(-(1 + nx) // TC_SLAB_K) * TC_SLAB_K


def _chunk_tiles(w: torch.Tensor) -> torch.Tensor:
    """(out, in) -> k16 chunks of all ``out`` rows: chunk c (input columns
    16 c ..) of 8 x 8 core matrices, core (i, j) of the chunk at (2 i + j)
    * 64 elements, chunk c at c * 16 out elements, flattened."""
    n, k = w.shape
    return w.reshape(n // 8, 8, k // 16, 2, 8).permute(2, 0, 3, 1, 4) \
        .reshape(-1)


def quad_frag_columns(k1: int, device=None) -> torch.Tensor:
    """Where each of layer 1's ``k1`` input columns goes in W1's images
    under ``pack_mlp_tc``'s ``quad_frags``: within each k16 chunk c, the
    quad 4 c + t (input columns 16 c + 4 t .. + 3) to the columns of
    thread t's A fragments, 16 c + 2 t, + 1, + 8, + 9 (wgmma's register
    layout of A), so that a thread draws whole quads of its rows."""
    i = torch.arange(k1, device=device)
    o = i % 16
    return 16 * (i // 16) + 2 * (o // 4) + (o % 2) + 8 * ((o % 4) // 2)


def pack_mlp_tc(mod: MLP, nx: int, pieces: int = 2,
                chunk_major: bool = False, quad_frags: bool = False):
    """The tensor-core kernels' net: (bf16 images, f32 vectors).

    Images, in ``_core_tiles`` layout, the ``pieces`` bf16 pieces of W
    (``bf16_pieces``: hi = bf16(W), lo = bf16(W - hi), and under the
    integral kernel's "highest" a third, bf16(W - hi - lo)) of W1 (its
    input columns reordered to x_1..x_nx, s, zero padding to
    ``tc_k1(nx)``, so that the draws' quads align with the k-chunks), then
    of each hidden layer's W (out, in); the forward pass reads W K-major
    and the backward pass the same bytes through the B transpose.
    Vectors: the L biases (H each), the head's weight row (H), the column
    sums over x of each piece of W1 (H each), the head's bias.
    ``chunk_major`` (generate.cu's width-256 instance, whose ring stages
    are k16 slabs of all the rows): W1's pieces and each hidden W's in
    ``_chunk_tiles`` order, each hidden W's pieces also in core order after
    them (its backward pass's chunks, rows 16 c .., are contiguous there),
    so that every stage is one copy. ``quad_frags`` (generate.cu's narrow
    instances, widths 64 and 128, whose layer 1 draws its input in
    registers): W1's columns within each k16 chunk in quad order
    (``quad_frag_columns``); the column sums are over the same columns."""
    lin = list(mod.layers)
    w1 = lin[0].weight.detach()
    w1c = torch.cat([w1[:, 1:], w1[:, :1],
                     w1.new_zeros((w1.shape[0], tc_k1(nx) - 1 - nx))], dim=1)
    if quad_frags:
        w1q = torch.empty_like(w1c)
        w1q[:, quad_frag_columns(w1c.shape[1], w1c.device)] = w1c
        w1c = w1q
    w1p = bf16_pieces(w1c, pieces)
    fwd = _chunk_tiles if chunk_major else _core_tiles
    images = [fwd(w.to(torch.bfloat16)) for w in w1p]
    for layer in lin[1:-1]:
        ws = [w.to(torch.bfloat16)
              for w in bf16_pieces(layer.weight.detach(), pieces)]
        images += [fwd(w) for w in ws]
        if chunk_major:
            images += [_core_tiles(w) for w in ws]
    vec = [layer.bias.detach() for layer in lin[:-1]]
    vec += [lin[-1].weight.detach().reshape(-1)]
    cols = (quad_frag_columns(w1c.shape[1], w1c.device)[:nx] if quad_frags
            else slice(0, nx))
    vec += [w[:, cols].sum(dim=1) for w in w1p]
    vec += [lin[-1].bias.detach().reshape(-1)]
    return (torch.cat(images).contiguous(),
            torch.cat([v.float() for v in vec]).contiguous())


def _net_for_launch(lib: ctypes.CDLL, name: str, sol: Solution,
                    tx: torch.Tensor, nx: int, tensor_cores: bool):
    """(module or None, hidden layers, scratch bytes) after the net
    kernels' limits: the tensor-core kernel's plan (0 or the global bytes
    its backward pass keeps when they do not fit in shared memory), or the
    FP32-FMA kernel's shared memory."""
    if nx > getattr(lib, f"dpi_{name}_max_nx")():
        raise NotImplementedError(
            f"nx={nx} exceeds the {name} kernel's "
            f"{getattr(lib, f'dpi_{name}_max_nx')()}")
    mod = kernel_net(sol, nx, getattr(lib, f"dpi_{name}_hidden_width")())
    n_hidden = len(mod.neurons) if mod is not None else 0
    scratch = 0
    if not tensor_cores:
        smem = getattr(lib, f"dpi_{name}_smem_bytes")(nx, n_hidden)
        if smem > MAX_SMEM_BYTES:
            raise NotImplementedError(
                f"the {name} kernel needs {smem} B of shared memory at "
                f"nx={nx}, {n_hidden} hidden layers (at most "
                f"{MAX_SMEM_BYTES})")
    else:
        scratch = getattr(lib, f"dpi_{name}_tc_scratch_bytes")(nx,
                                                                n_hidden)
        if scratch < 0:
            raise NotImplementedError(
                f"the {name} tensor-core kernel has no launch plan at "
                f"nx={nx}, {n_hidden} hidden layers")
    if mod is not None and next(mod.parameters()).device != tx.device:
        raise ValueError("the frozen net must lie on the device of tx")
    return mod, n_hidden, scratch


def _tc_net_for_launch(dll: ctypes.CDLL, sol: Solution, tx: torch.Tensor,
                       nx: int):
    """(module or None, hidden layers, scratch bytes) of the merged
    tensor-core kernel in the built library ``dll``: the scratch its plan
    keeps at the net's width."""
    widths = (ctypes.c_int * TC_WIDTHS_CAP)()
    widths = tuple(widths[:dll.dpi_generate_tc_widths(widths)])
    if nx > dll.dpi_generate_tc_max_nx():
        raise NotImplementedError(
            f"nx={nx} exceeds the generate kernel's "
            f"{dll.dpi_generate_tc_max_nx()}")
    mod = kernel_net(sol, nx, widths)
    n_hidden = len(mod.neurons) if mod is not None else 0
    width = mod.neurons[0] if mod is not None else KERNEL_WIDTH
    scratch = dll.dpi_generate_tc_scratch_bytes_w(nx, n_hidden, width)
    if scratch < 0:
        raise NotImplementedError(
            f"the generate tensor-core kernel has no launch plan at nx={nx}, "
            f"{n_hidden} hidden layers of width {width}")
    if mod is not None and next(mod.parameters()).device != tx.device:
        raise ValueError("the frozen net must lie on the device of tx")
    return mod, n_hidden, scratch


def _tc_net(mod: Optional[MLP], nx: int, scratch: int, device,
            pieces: int = 2, chunk_major: bool = False,
            quad_frags: bool = False):
    """The tensor-core launch's net buffers and scratch (None where
    unused)."""
    img = vec = None
    if mod is not None:
        img, vec = pack_mlp_tc(mod, nx, pieces, chunk_major, quad_frags)
    buf = (torch.empty(scratch // 4, dtype=torch.float32, device=device)
           if scratch > 0 else None)
    return img, vec, buf


# ---------------------------------------------------------------------------
# merged terminal + integral estimator (TPU: _generate_kernel)
# ---------------------------------------------------------------------------

# csrc/generate.cu's tensor-core kernel: its block's two consumer warpgroups
# on 64-row tiles and a ring stage's bytes (value_mlp_tc.cuh: TILE,
# STAGE_BYTES), which set the L2 traffic of ``generate_tc_l2_bytes``
TC_TILE, TC_NWG, TC_STAGE_BYTES = 64, 2, 32768
# one layer's saved elu'(z) of a tile, by hidden width
TC_SAVE_LAYER_FLOATS = {w: TC_TILE * w for w in GENERATE_TC_WIDTHS}
# the width whose instance keeps the layer chain on chip (generate.cu:
# N256; its ring stages are k16 slabs of all its rows)
TC_ON_CHIP_WIDTH = 256


def generate_tc_instance(width: int):
    """The tensor-core kernel's instance for a covered hidden width, from
    the width alone (generate.cu's ``instance_of``): 64, 128 and 256 their
    own, "wide" (``net_pass_wide``) for 384 to 1024."""
    if width not in GENERATE_TC_WIDTHS:
        raise ValueError(f"width {width} is not covered")
    return width if width in (64, 128, TC_ON_CHIP_WIDTH) else "wide"


def library_tc_plan(nx: int, n_hidden: int,
                    lib: Optional[CudaLibrary] = None,
                    width: int = KERNEL_WIDTH,
                    precision: str = "bf16x3") -> Optional[dict]:
    """The plan the built ``generate.cu`` (``lib``, default ``GENERATE``)
    takes at (nx, hidden layers, hidden width) (its plan_of): the ring's
    stages in ``precision``'s mode (the wide pass runs twice as many of
    half the bytes under "default" as under bf16x3, at most 8), whether
    the saved ELU derivatives and the tiles' normals stay in shared memory,
    the block's shared memory and the global scratch floats it keeps,
    whether the instance keeps the layer chain on chip and draws the
    normals where it uses them ("on_chip"), whether its producer stages the
    products' A (the layer inputs' bf16 images) beside the weights
    ("a_staged": the wide pass of widths 384 to 1024), a ring stage's
    bytes in that mode ("stage_bytes"), and whether layer 1 draws the
    integral normals into its A fragments, W1's columns in quad order
    ("quad_frags": the narrow instances, widths 64 and 128; a build before
    a key reports False or 0). None where nothing fits."""
    out = (ctypes.c_longlong * 11)()
    (lib or GENERATE).lib().dpi_generate_tc_plan_w(nx, n_hidden, width, out)
    if out[0] < 0:
        return None
    one_pass = precision == "default"
    return {"stages": out[8] if one_pass else out[0],
            "save_smem": bool(out[1]),
            "dw_smem": bool(out[2]), "smem_bytes": out[3],
            "scratch_floats": out[4], "on_chip": bool(out[5]),
            "a_staged": bool(out[6]),
            "stage_bytes": out[9] if one_pass else out[7],
            "quad_frags": bool(out[10])}


def generate_tc_l2_bytes(b: int, m: int, nx: int, n_hidden: int,
                         precision: str, plan: dict,
                         width: int = KERNEL_WIDTH) -> dict:
    """Bytes one launch of the merged tensor-core kernel moves through L2
    by ``plan`` (``library_tc_plan``'s): the weight slabs the producer
    stages (each ring pass serves the two warpgroups' tiles of a point; hi
    and lo images under bf16x3, hi alone under "default"; a slab is 128
    output rows (at width 64 the layer's 64), so a layer of width past 128
    takes width / 128 column blocks of width / 64 K-slabs each, and its
    first layer's K-slabs are staged once for each block), and the global
    scratch: the saved derivatives written and read once a tile, the
    tiles' normals written once and read twice (layer 1's input, the sums;
    past width 128 once more for each further block of layer 1) where the
    plan keeps them there, and past width 128 the layer outputs (TILE x
    width f32 a layer: layers 1..L forward and L-1..2 backward written,
    each of the 2 (L - 1) hidden products' inputs read once a block). A
    plan "on_chip" (width 256) stages k16 slabs of all the layer's rows,
    layer 1's ceil((1 + nx) / 16) once, keeps the layer outputs on chip,
    and in scratch the saved derivatives and each tile's normals of both
    chains (quads of nx padded to 4: written where drawn, read once by the
    sums). A plan "a_staged" (widths 384 to 1024) stages the same weight
    slabs and, beside them, each block's A: the tiles' layer inputs as bf16
    images (hi and lo under bf16x3, hi alone under "default"), layer 1's
    [X_s, s] of tc_k1(nx) columns and each hidden product's input, read
    once for each of the ceil(width / 256) column blocks; in scratch those
    images written once (each product's input: layer 1's by the draws,
    the others by the layer before), the saved
    derivatives written and read once a tile, and the tiles' normals
    written once and read once (the sums). A plan "quad_frags" (widths 64
    and 128) keeps the tiles' normals (rows of whole quads) where layer 1
    draws them, written once and read once by the sums. A count of the
    plan, not a measurement."""
    passes = -(-(-(-m // TC_TILE)) // TC_NWG)
    if plan.get("a_staged"):
        pieces = 2 if precision == "bf16x3" else 1
        blocks = -(-width // 256)
        ks = ([tc_k1(nx)] + [width] * (2 * n_hidden - 2)) if n_hidden else []
        tiles = b * passes * TC_NWG
        weights = b * passes * sum(width * k * 2 * pieces for k in ks)
        reads = tiles * sum(blocks * TC_TILE * k * 2 * pieces for k in ks)
        writes = tiles * TC_TILE * 2 * pieces * sum(ks)
        saves = (0 if n_hidden < 2 else tiles * (n_hidden - 1)
                 * TC_SAVE_LAYER_FLOATS[width] * 4 * 2)
        normals = tiles * TC_TILE * nx * 4 * 2
        scratch = reads + writes + saves + normals
        return {"weights": weights, "scratch": scratch,
                "total": weights + scratch}
    if plan.get("on_chip"):
        chunks = (-(-(1 + nx) // 16) + 2 * (width // 16) * (n_hidden - 1)
                  if n_hidden else 0)
        weights = (b * passes * chunks * width * 16 * 2
                   * (2 if precision == "bf16x3" else 1))
        tiles = b * passes * TC_NWG
        saves = (0 if n_hidden < 2 else tiles * (n_hidden - 1)
                 * TC_SAVE_LAYER_FLOATS[width] * 4 * 2)
        normals = tiles * 2 * TC_TILE * 4 * -(-nx // 4) * 4 * 2
        return {"weights": weights, "scratch": saves + normals,
                "total": weights + saves + normals}
    blocks = max(1, width // 128)
    slabs = (blocks * tc_k1(nx) // TC_SLAB_K
             + 2 * blocks * (width // TC_SLAB_K) * (n_hidden - 1)
             if n_hidden else 0)
    slab = (TC_STAGE_BYTES // (1 if precision == "bf16x3" else 2)
            * min(width, 128) // 128)
    tiles = b * passes * TC_NWG
    saves = (0 if plan["save_smem"] or n_hidden < 2 else
             tiles * (n_hidden - 1) * TC_SAVE_LAYER_FLOATS[width] * 4 * 2)
    reads = 2 + (blocks if n_hidden else 1)
    normals = 0 if plan["dw_smem"] else tiles * TC_TILE * nx * 4 * reads
    if plan.get("quad_frags") and not plan["dw_smem"]:
        normals = tiles * TC_TILE * 4 * -(-nx // 4) * 4 * 2
    acts = 0
    if blocks > 1 and n_hidden > 1:
        layer = TC_TILE * width * 4
        acts = tiles * layer * ((2 * n_hidden - 2)
                                + blocks * 2 * (n_hidden - 1))
    weights = b * passes * slabs * slab
    scratch = saves + normals + acts
    return {"weights": weights, "scratch": scratch,
            "total": weights + scratch}


def generate_with_gradients_plain(seed: int, eq, sol: Solution,
                                  tx: torch.Tensor, m: int,
                                  u01: Optional[torch.Tensor] = None,
                                  noise_t: Optional[torch.Tensor] = None,
                                  noise_i: Optional[torch.Tensor] = None, *,
                                  antithetic: bool = False,
                                  precision: str = "highest",
                                  chunk_rows: int = 2 ** 16,
                                  return_var: bool = False):
    """Plain PyTorch version of the merged estimator kernel.

    Same signature and meaning as ``generate_with_gradients_cuda``: with
    external ``u01`` (B, rows, 1), ``noise_t`` and ``noise_i`` (B, rows,
    nx), rows = ``draw_rows(m, antithetic)``, it uses them, else it draws
    them chunk by chunk from a torch.Generator seeded with ``seed``.
    ``precision`` is that of the frozen-net dots along the integral chain
    (``PRECISIONS``; f0 stays f32, as in the TPU kernel's wrapper).
    Chunked over m so that at most about ``chunk_rows`` samples pass
    through the frozen net at once. ``return_var`` also returns the
    per-sample variance of each of the 1 + nx outputs (for CLT checks; see
    ``_accumulate``)."""
    t, x = tx[:, :1], tx[:, 1:]
    b, nx = x.shape
    Tt = torch.clamp(eq.T - t, min=1e-6)
    sqrt_Tt = torch.sqrt(Tt)
    inv_yT = 1.0 / (sqrt_Tt * eq.alpha_sqrt)
    g0 = eq.g(x)
    f0 = get_f(eq, sol, t, x)
    sol_p = with_precision(sol, precision)
    external = None
    if noise_t is not None:
        external = {"u": u01, "nt": noise_t, "ni": noise_i}
    chunks = _draw_chunks(seed, tx, m, antithetic, chunk_rows,
                          [("u", 1, "u"), ("nt", nx, "n"), ("ni", nx, "n")],
                          external)
    mean, var = _accumulate(
        (_terminal_z(eq, x, sqrt_Tt, g0, inv_yT, c["nt"])
         + _integral_z(eq, sol_p, t, x, Tt, f0, c["u"], c["ni"])
         for c in chunks), b, 1 + nx, m, antithetic, tx, return_var)
    out = _with_value_offset(mean, g0 + f0 * Tt)
    return (out, var) if return_var else out


def generate_with_gradients_cuda(seed: int, eq, sol: Solution,
                                 tx: torch.Tensor, m: int,
                                 u01: Optional[torch.Tensor] = None,
                                 noise_t: Optional[torch.Tensor] = None,
                                 noise_i: Optional[torch.Tensor] = None, *,
                                 antithetic: bool = False,
                                 precision: str = "highest",
                                 lib: Optional[CudaLibrary] = None
                                 ) -> torch.Tensor:
    """Merged terminal + integral estimator, (B, 1 + nx) f32.

    ``m`` is the shared per-point sample count of both chains. Without
    external noise the kernel draws its own normals (Philox4x32-10 keyed by
    (seed, point)); with ``u01`` (B, rows, 1) and ``noise_t``/``noise_i``
    (B, rows, nx) it uses those, as the TPU kernel does (its test path).
    ``antithetic`` pairs each draw with its mirror: rows = m / 2.
    ``precision`` (``PRECISIONS``): "highest" launches the FP32-FMA kernel,
    "bf16x3" and "default" the tensor-core kernel (``GENERATE_TC_WIDTHS``:
    hidden width 64, 128, or 256 to 1024 in steps of 128, nx up to
    ``GENERATE_TC_MAX_NX``). CPU tensors take
    ``generate_with_gradients_plain``; on any other device a case the
    kernel does not cover (``merged_covers``) raises NotImplementedError
    before the library is loaded. ``lib``: another build of
    ``generate.cu`` (``utils/generate_bench.py``) in place of
    ``GENERATE``."""
    check_precision(precision)
    if tx.device.type == "cpu":
        return generate_with_gradients_plain(seed, eq, sol, tx, m, u01,
                                             noise_t, noise_i,
                                             antithetic=antithetic,
                                             precision=precision)
    why = merged_covers(eq, sol, precision)
    if why is not None:
        raise NotImplementedError(f"the CUDA merged estimator kernel: {why}")
    _on_card("estimator", tx, eq)
    b, nx = tx.shape[0], tx.shape[1] - 1
    _check("tx", tx, (b, 1 + nx), tx.device)
    rows = draw_rows(m, antithetic)
    ext = [v is not None for v in (u01, noise_t, noise_i)]
    if any(ext) and not all(ext):
        raise ValueError("external noise needs all of u01, noise_t, noise_i")
    if all(ext):
        _check("u01", u01, (b, rows, 1), tx.device)
        _check("noise_t", noise_t, (b, rows, nx), tx.device)
        _check("noise_i", noise_i, (b, rows, nx), tx.device)
    lib = lib or GENERATE
    dll = lib.lib()
    if precision == "highest":
        mod, n_hidden, scratch = _net_for_launch(dll, "generate", sol, tx,
                                                 nx, False)
    else:
        mod, n_hidden, scratch = _tc_net_for_launch(dll, sol, tx, nx)
    width = mod.neurons[0] if mod is not None else KERNEL_WIDTH
    t = tx[:, :1].contiguous()
    x = tx[:, 1:].contiguous()
    g0 = eq.g(x).contiguous()
    f0 = get_f(eq, sol, t, x).contiguous()
    out = torch.empty((b, 1 + nx), dtype=torch.float32, device=tx.device)
    shape = (b, int(m), nx, n_hidden, int(mod is not None), int(antithetic))
    scalars = (_seed(seed), float(eq.T), float(eq.alpha_sqrt), float(eq.k),
               float(eq.ff_offset), _stream(tx.device))
    if precision == "highest":
        w = pack_mlp(mod) if mod is not None else None
        rc = dll.dpi_generate(
            _ptr(t), _ptr(x), _ptr(g0), _ptr(f0), _ptr(w), _ptr(u01),
            _ptr(noise_t), _ptr(noise_i), _ptr(out), *shape, *scalars)
    else:
        # the instances that keep the layer chain on chip or stage A stage
        # contiguous chunks (a build from before them reports neither)
        plan = library_tc_plan(nx, n_hidden, lib, width)
        img, vec, buf = _tc_net(mod, nx, scratch, tx.device,
                                chunk_major=plan["on_chip"]
                                or plan["a_staged"],
                                quad_frags=plan["quad_frags"])
        rc = dll.dpi_generate_tc_w(
            _ptr(t), _ptr(x), _ptr(g0), _ptr(f0), _ptr(img), _ptr(vec),
            _ptr(u01), _ptr(noise_t), _ptr(noise_i), _ptr(buf), _ptr(out),
            *shape, _TC_MODES[precision], width, *scalars)
    if rc != 0:
        raise RuntimeError(f"dpi_generate launch failed: error {rc} (CUDA's, "
                           f"or value_mlp_tc.cuh's ERR_* from 10001)")
    lib.count(precision)
    return out


# ---------------------------------------------------------------------------
# the merged estimator's HJB instance: OU + PISGradNet (csrc/generate_pis.cu)
# ---------------------------------------------------------------------------

# the PISGradNet the kernel is built for (generate_pis.cu: HW, CH, MAX_NX),
# held equal to the built library's by the card tests; up to
# PIS_NARROW_NX the head and the x columns of N_0^T are 128 rows, beyond it
# 512 (generate_pis.cu: NARROW_NX, head_rows)
PIS_WIDTH, PIS_CHANNELS, PIS_MAX_NX = 512, 64, 512
PIS_NARROW_NX = 128


def pis_head_rows(nx: int) -> int:
    return 128 if nx <= PIS_NARROW_NX else PIS_WIDTH


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def pis_layer_shapes(n_hidden: int, nx: int):
    """(N, K) of the kernel's products in the order it takes them
    (generate_pis.cu:layer_nk): the gate S_0..S_L, the time encoder
    T_0, T_1, the net N_0..N_{L-1} and its head, then backward the head^T,
    N_{L-1}^T..N_1^T and the x columns of N_0^T; N padded to 128 or 512
    (the head and N_0x^T: ``pis_head_rows``), K to 16."""
    L, c, w, h = n_hidden, PIS_CHANNELS, PIS_WIDTH, pis_head_rows(nx)
    return ([(128, 2 * c)] + [(128, c)] * L + [(128, 2 * c), (128, c)]
            + [(w, _pad16(c + nx))] + [(w, w)] * (L - 1) + [(h, w)]
            + [(w, _pad16(nx))] + [(w, w)] * (L - 1) + [(h, w)])


def _slab_image(w: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """(N, K) B operand, zero-padded to (n, k), as the kernel's k16 slabs:
    per slab the bf16 hi image then the lo image, each of 8 x 8 core
    matrices, core (row / 8, col % 16 / 8) at (row / 8 x 2 + col % 16 / 8)
    x 64 elements (K-major, no swizzle)."""
    pad = w.new_zeros((n, k))
    pad[:w.shape[0], :w.shape[1]] = w
    hi = pad.to(torch.bfloat16)
    lo = (pad - hi.float()).to(torch.bfloat16)

    def slabs(a):
        return a.reshape(n // 8, 8, k // 16, 2, 8).permute(
            2, 0, 3, 1, 4).reshape(k // 16, n * 16)

    return torch.stack([slabs(hi), slabs(lo)], dim=1).reshape(-1)


def pack_pis_tc(mod: PISGradNet, nx: int):
    """The PIS kernel's net: (bf16 slab images in ``pis_layer_shapes``
    order, f32 vector: the embedding's coefficients and phase, the gate's
    biases S_0..S_L, its head's row 0 and bias 0, the encoder's biases,
    the net's biases and its head's; generate_pis.cu:vec_layout)."""
    L = len(mod.hidden_shapes)
    sn, te, nn_ = list(mod.smooth_net), list(mod.t_encoder), \
        list(mod.nn_module)
    c = PIS_CHANNELS
    mats = ([lin.weight for lin in sn[:L + 1]]
            + [lin.weight for lin in te]
            + [lin.weight for lin in nn_]
            + [nn_[-1].weight.t()]
            + [nn_[l].weight.t() for l in range(L - 1, 0, -1)]
            + [nn_[0].weight[:, c:c + nx].t()])
    shapes = pis_layer_shapes(L, nx)
    img = torch.cat([_slab_image(w.detach().float(), n, k)
                     for w, (n, k) in zip(mats, shapes)])
    vec = ([mod.timestep_coeff.reshape(-1), mod.timestep_phase.reshape(-1)]
           + [lin.bias for lin in sn[:L + 1]]
           + [sn[L + 1].weight[0], sn[L + 1].bias[:1]]
           + [lin.bias for lin in te] + [lin.bias for lin in nn_])
    return (img.contiguous(),
            torch.cat([v.detach().float().reshape(-1) for v in vec])
            .contiguous())


def pack_gmm(eq: OUProcessEquation) -> torch.Tensor:
    """The mixture as the kernel reads it: means, vars (K, nx), log-weights
    and the normalisers sum_j log v_kj + nx log 2 pi (K), flat f32."""
    norm = (torch.sum(torch.log(eq.gmm_vars), dim=-1)
            + eq.nx * math.log(2.0 * math.pi))
    return torch.cat([eq.gmm_means.reshape(-1), eq.gmm_vars.reshape(-1),
                      eq.gmm_log_weights.reshape(-1), norm]).float() \
        .contiguous()


def kernel_pis(sol: Solution, nx: int) -> Optional[PISGradNet]:
    """The PISGradNet the PIS kernel runs for ``sol`` (None for the zero
    iterate). Raises for a frozen iterate it does not cover."""
    if sol.kind == "zero":
        return None
    mod = sol.module
    if not (sol.kind == "net" and sol.net_type == VALUE
            and isinstance(mod, PISGradNet)):
        raise NotImplementedError(
            "the CUDA PIS estimator kernel covers the zero iterate and "
            f"PISGradNets only (got module={type(mod).__name__})")
    if (not mod.hidden_shapes
            or any(n != PIS_WIDTH for n in mod.hidden_shapes)
            or mod.channels != PIS_CHANNELS or mod.dim != nx):
        raise NotImplementedError(
            f"the CUDA PIS estimator kernel covers PISGradNets of hidden "
            f"width {PIS_WIDTH} and {PIS_CHANNELS} channels (got "
            f"{mod.hidden_shapes}, {mod.channels} channels)")
    if any(p.dtype != torch.float32 for p in mod.parameters()):
        raise NotImplementedError("the CUDA PIS estimator kernel is f32 only")
    return mod


def pis_covers(eq, sol: Solution, precision: str, antithetic: bool):
    """None where the PIS kernel covers (eq, sol) in ``precision``, else
    why not (the structure alone, before any launch)."""
    if not isinstance(eq, OUProcessEquation):
        return f"it covers the OU equation, not {type(eq).__name__}"
    if eq.nx > PIS_MAX_NX:
        return f"nx={eq.nx} exceeds its {PIS_MAX_NX}"
    if antithetic:
        return "it has no antithetic pairing"
    try:
        kernel_pis(sol, eq.nx)
    except NotImplementedError as e:
        return str(e)
    if sol.kind != "zero" and check_precision(precision) == "highest":
        return "it has no FP32 ('highest') net pass"
    return None


# the keys of ``library_pis_plan``'s dict, in generate_pis.cu's order
PIS_PLAN_KEYS = ("stages", "dw_smem", "smem_bytes", "scratch_floats",
                 "term_strips", "scratch_strips", "term_sums_smem",
                 "producer_regs", "consumer_regs", "normals_reads",
                 "w_term_scratch")


def library_pis_plan(nx: int, n_hidden: int, precision: str,
                     ncomp: int = 5, has_net: bool = True,
                     lib: Optional[CudaLibrary] = None) -> Optional[dict]:
    """The plan the built ``generate_pis.cu`` (``lib``, default
    ``GENERATE_PIS``) takes at (nx, hidden layers, precision, mixture
    components): the ring's stages, whether the tile's normals stay in
    shared memory, the block's shared memory and the global scratch floats
    it keeps, the terminal chain's strips (one a warp of the wide
    instance's chain) in shared memory and in scratch and whether its sums
    stay in shared memory, the registers a producer-warpgroup and a
    consumer thread keep after setmaxnreg, the passes that read a tile's
    normals back from scratch, and whether w's mixture term goes through
    scratch. None where nothing fits."""
    out = (ctypes.c_longlong * len(PIS_PLAN_KEYS))()
    (lib or GENERATE_PIS).lib().dpi_generate_pis_plan(
        nx, ncomp, int(has_net), _TC_MODES[check_precision(precision)],
        n_hidden, out)
    if out[0] < 0:
        return None
    plan = dict(zip(PIS_PLAN_KEYS, out))
    for key in ("dw_smem", "term_sums_smem", "w_term_scratch"):
        plan[key] = bool(plan[key])
    return plan


def generate_pis_l2_bytes(b: int, m: int, nx: int, n_hidden: int,
                          precision: str, plan: dict) -> dict:
    """Bytes one launch of the PIS kernel moves through L2 by ``plan``
    (``library_pis_plan``'s): the weight stages the producer copies, each
    tile of 64 samples (a ring pass serves one tile: both warpgroups take
    its rows), ``generate_pis.cu:produce``'s copies per layer (a stage's
    slabs of the layer's ``layer_rows``, hi and lo images under bf16x3, a
    last "default" stage of two 512-row slabs whole); and the global
    scratch: the head's output (or w's first terms) and the L layers'
    ELU'(z) (f32) written and read once a tile;
    where the plan keeps them in scratch, the tile's normals (64 x nx
    padded to 4) written once and read the plan's "normals_reads" times,
    w's mixture term (as many) written and read once, the terminal sums of each point (3 x (1 + nx))
    written and read once, and the terminal strips (nx padded to 4) read
    and written once a draw (the warp's sums over the draws). A count of
    the plan, not a measurement."""
    x3 = check_precision(precision) == "bf16x3"
    hw, c, head = PIS_WIDTH, PIS_CHANNELS, pis_head_rows(nx)
    per_tile = 0
    for i, (n, k) in enumerate(pis_layer_shapes(n_hidden, nx)):
        rows = c if i <= n_hidden + 2 else n
        img = rows * 32
        spc = (1 if x3 else 2) if rows == hw else (2 if x3 and rows == 128
                                                   else 4)
        if x3 and rows == hw:
            per_tile += 2 * (k // 16) * img
        else:
            per_tile += -(-(k // 16) // spc) * spc * img * (2 if x3 else 1)
    tiles = b * -(-m // 64)
    tile = 64 * -(-nx // 4) * 4 * 4  # a tile's normals, bytes
    normals = 0 if plan["dw_smem"] else tile * (1 + plan["normals_reads"])
    normals += 2 * tile if plan["w_term_scratch"] else 0
    net = 64 * (head + n_hidden * hw) * 4
    scratch = (tiles * (net * 2 + normals)
               + (0 if plan["term_sums_smem"] else b * 3 * (1 + nx) * 4 * 2)
               + (b * m * -(-nx // 4) * 4 * 4 * 2 if plan["scratch_strips"]
                  else 0))
    weights = tiles * per_tile
    return {"weights": weights, "scratch": scratch,
            "total": weights + scratch}


def pis_sigma0(mod: PISGradNet, precision: str) -> float:
    """S(e(0))[0], the gate's constant, in ``precision`` as the plain
    version computes it."""
    with torch.no_grad():
        z = torch.zeros((1, 1), dtype=torch.float32,
                        device=mod.timestep_phase.device)
        dot = None
        if precision != "highest":
            def dot(a, b):
                return precision_dot(a, b, precision)
        return float(mod.smooth(mod.embedding(z), dot)[0, 0])


def generate_pis_cuda(seed: int, eq, sol: Solution, tx: torch.Tensor,
                      m: int, u01: Optional[torch.Tensor] = None,
                      noise_t: Optional[torch.Tensor] = None,
                      noise_i: Optional[torch.Tensor] = None, *,
                      antithetic: bool = False,
                      precision: str = "default",
                      lib: Optional[CudaLibrary] = None) -> torch.Tensor:
    """Merged terminal + integral estimator for the OU equation and a
    PISGradNet (or the zero) iterate, (B, 1 + nx) f32: the PIS kernel for
    CUDA tensors (Philox draws keyed by (seed, point), or external ``u01``
    (B, m, 1), ``noise_t``/``noise_i`` (B, m, nx)), in ``precision``
    "default" or "bf16x3"; ``generate_with_gradients_plain`` for CPU
    tensors. Raises for what the kernel does not cover (``pis_covers``).
    ``lib``: another build of ``generate_pis.cu`` (``utils/pis_bench.py``)
    in place of ``GENERATE_PIS``."""
    check_precision(precision)
    if tx.device.type == "cpu":
        return generate_with_gradients_plain(seed, eq, sol, tx, m, u01,
                                             noise_t, noise_i,
                                             antithetic=antithetic,
                                             precision=precision)
    _on_card("PIS estimator", tx, eq, OUProcessEquation)
    why = pis_covers(eq, sol, precision, antithetic)
    if why is not None:
        raise NotImplementedError(f"the CUDA PIS estimator kernel: {why}")
    b, nx = tx.shape[0], tx.shape[1] - 1
    _check("tx", tx, (b, 1 + nx), tx.device)
    ext = [v is not None for v in (u01, noise_t, noise_i)]
    if any(ext) and not all(ext):
        raise ValueError("external noise needs all of u01, noise_t, noise_i")
    if all(ext):
        _check("u01", u01, (b, m, 1), tx.device)
        _check("noise_t", noise_t, (b, m, nx), tx.device)
        _check("noise_i", noise_i, (b, m, nx), tx.device)
    mod = kernel_pis(sol, nx)
    has_net = int(mod is not None)
    n_hidden = len(mod.hidden_shapes) if has_net else 0
    mode = _TC_MODES.get(precision, _TC_MODES["bf16x3"])
    ncomp = int(eq.gmm_means.shape[0])
    lib = lib or GENERATE_PIS
    dll = lib.lib()
    if ncomp > dll.dpi_generate_pis_max_components():
        raise NotImplementedError(
            f"{ncomp} mixture components exceed the PIS kernel's "
            f"{dll.dpi_generate_pis_max_components()}")
    smem = dll.dpi_generate_pis_smem_bytes(nx, ncomp, has_net, mode)
    if not 0 < smem <= MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"the PIS kernel has no launch plan at nx={nx}, {ncomp} "
            f"components, precision {precision!r}")
    grid = dll.dpi_generate_pis_grid(nx, ncomp, has_net, mode, b)
    if grid < 1:
        raise RuntimeError("the PIS kernel found no grid on this card")
    img = vec = scratch = None
    sigma0 = 0.0
    if has_net:
        if next(mod.parameters()).device != tx.device:
            raise ValueError("the frozen net must lie on the device of tx")
        img, vec = pack_pis_tc(mod, nx)
        if (img.numel() != dll.dpi_generate_pis_image_elems(nx, n_hidden)
                or vec.numel() != dll.dpi_generate_pis_vec_floats(
                    nx, n_hidden)):
            raise RuntimeError("pack_pis_tc and generate_pis.cu disagree "
                               "on the packed net's layout")
        scratch = torch.empty(
            grid * dll.dpi_generate_pis_scratch_floats_nx(n_hidden, nx,
                                                          ncomp, mode),
            dtype=torch.float32, device=tx.device)
        sigma0 = pis_sigma0(mod, precision)
    t = tx[:, :1].contiguous()
    x = tx[:, 1:].contiguous()
    g0 = eq.g(x).contiguous()
    f0 = get_f(eq, sol, t, x).contiguous()
    gmm = pack_gmm(eq).to(tx.device)
    out = torch.empty((b, 1 + nx), dtype=torch.float32, device=tx.device)
    rc = dll.dpi_generate_pis(
        _ptr(t), _ptr(x), _ptr(g0), _ptr(f0), _ptr(img), _ptr(vec),
        _ptr(gmm), _ptr(u01), _ptr(noise_t), _ptr(noise_i), _ptr(scratch),
        _ptr(out), b, int(m), nx, n_hidden, has_net, ncomp, mode, grid,
        _seed(seed), float(eq.T), float(eq.alpha_sqrt), float(eq.theta),
        float(eq.mu), float(0.5 * eq.alpha), float(eq.nx * eq.theta),
        sigma0, _stream(tx.device))
    if rc != 0:
        raise RuntimeError(f"dpi_generate_pis launch failed: error {rc} "
                           "(CUDA's, or generate_pis.cu's ERR_* from 10001)")
    lib.count(precision)
    return out


# ---------------------------------------------------------------------------
# terminal estimator alone (TPU: _terminal_kernel)
# ---------------------------------------------------------------------------

def terminal_with_gradients_plain(seed: int, eq, tx: torch.Tensor, m: int,
                                  noise: Optional[torch.Tensor] = None, *,
                                  antithetic: bool = False,
                                  chunk_rows: int = 2 ** 16,
                                  return_var: bool = False):
    """Plain PyTorch version of the terminal kernel:
    E[(g(X_T) - g0) (1, Y)] + (g0, 0), Tt floored at 1e-6. ``noise``
    (B, rows, nx), rows = ``draw_rows(m, antithetic)``, or draws from a
    torch.Generator seeded with ``seed``."""
    t, x = tx[:, :1], tx[:, 1:]
    b, nx = x.shape
    sqrt_Tt = torch.sqrt(torch.clamp(eq.T - t, min=1e-6))
    inv_y = 1.0 / (sqrt_Tt * eq.alpha_sqrt)
    g0 = eq.g(x)
    chunks = _draw_chunks(seed, tx, m, antithetic, chunk_rows,
                          [("n", nx, "n")],
                          None if noise is None else {"n": noise})
    mean, var = _accumulate(
        (_terminal_z(eq, x, sqrt_Tt, g0, inv_y, c["n"]) for c in chunks),
        b, 1 + nx, m, antithetic, tx, return_var)
    out = _with_value_offset(mean, g0)
    return (out, var) if return_var else out


def terminal_with_gradients_cuda(seed: int, eq, tx: torch.Tensor, m: int,
                                 noise: Optional[torch.Tensor] = None, *,
                                 antithetic: bool = False) -> torch.Tensor:
    """Terminal CV estimator, (B, 1 + nx) f32: the terminal kernel for CUDA
    tensors (Philox draws keyed by (seed, point), or external ``noise``
    (B, rows, nx)), the plain version for CPU tensors."""
    if tx.device.type == "cpu":
        return terminal_with_gradients_plain(seed, eq, tx, m, noise,
                                             antithetic=antithetic)
    _on_card("terminal", tx, eq)
    b, nx = tx.shape[0], tx.shape[1] - 1
    _check("tx", tx, (b, 1 + nx), tx.device)
    rows = draw_rows(m, antithetic)
    if noise is not None:
        _check("noise", noise, (b, rows, nx), tx.device)
    lib = TERMINAL.lib()
    if lib.dpi_terminal_smem_bytes(nx) < 0:
        raise NotImplementedError(
            f"nx={nx}: the terminal kernel covers 1 <= nx <= "
            f"{lib.dpi_terminal_max_nx()}")
    t = tx[:, :1].contiguous()
    x = tx[:, 1:].contiguous()
    g0 = eq.g(x).contiguous()
    out = torch.empty((b, 1 + nx), dtype=torch.float32, device=tx.device)
    rc = lib.dpi_terminal(
        _ptr(t), _ptr(x), _ptr(g0), _ptr(noise), _ptr(out), b, int(m), nx,
        int(antithetic), _seed(seed), float(eq.T), float(eq.alpha_sqrt),
        float(eq.k), _stream(tx.device))
    if rc != 0:
        raise RuntimeError(f"dpi_terminal launch failed: CUDA error {rc}")
    TERMINAL.count()
    return out


def terminal_draw_mismatches(device) -> int:
    """Mismatches of the terminal kernel's Box-Muller (its guard-free copy
    of the library's logf, sqrtf and sincosf) against philox.cuh's, bit
    for bit, over all 2^23 uniforms a draw word gives: 0 when its draws are
    the other kernels' and the host reference's."""
    device = torch.device(device)
    bad = torch.zeros(1, dtype=torch.int32, device=device)
    rc = TERMINAL.lib().dpi_terminal_check_draws(_ptr(bad), _stream(device))
    if rc != 0:
        raise RuntimeError(f"dpi_terminal_check_draws failed: CUDA error "
                           f"{rc}")
    return int(bad.item())


# ---------------------------------------------------------------------------
# integral estimator alone (TPU: _integral_kernel)
# ---------------------------------------------------------------------------

def integral_with_gradients_plain(seed: int, eq, sol: Solution,
                                  tx: torch.Tensor, m: int,
                                  u01: Optional[torch.Tensor] = None,
                                  noise: Optional[torch.Tensor] = None, *,
                                  antithetic: bool = False,
                                  f0: Optional[torch.Tensor] = None,
                                  precision: str = "highest",
                                  chunk_rows: int = 2 ** 16,
                                  return_var: bool = False):
    """Plain PyTorch version of the integral kernel:
    E[Tt (f - f0) (1, Ys)] + (f0 Tt, 0), Tt = T - t. ``u01`` (B, rows, 1)
    and ``noise`` (B, rows, nx), or draws from a torch.Generator seeded
    with ``seed``; pairs share u. ``f0`` defaults to f at (t, x), in f32;
    ``precision`` is that of the frozen-net dots at the samples."""
    t, x = tx[:, :1], tx[:, 1:]
    b, nx = x.shape
    Tt = eq.T - t
    if f0 is None:
        f0 = get_f(eq, sol, t, x)
    external = None if noise is None else {"u": u01, "n": noise}
    chunks = _draw_chunks(seed, tx, m, antithetic, chunk_rows,
                          [("u", 1, "u"), ("n", nx, "n")], external)
    sol_p = with_precision(sol, precision)
    mean, var = _accumulate(
        (_integral_z(eq, sol_p, t, x, Tt, f0, c["u"], c["n"])
         for c in chunks),
        b, 1 + nx, m, antithetic, tx, return_var)
    out = _with_value_offset(mean, f0 * Tt)
    return (out, var) if return_var else out


def integral_with_gradients_cuda(seed: int, eq, sol: Solution,
                                 tx: torch.Tensor, m: int,
                                 u01: Optional[torch.Tensor] = None,
                                 noise: Optional[torch.Tensor] = None, *,
                                 antithetic: bool = False,
                                 f0: Optional[torch.Tensor] = None,
                                 precision: str = "highest",
                                 lib: Optional[CudaLibrary] = None
                                 ) -> torch.Tensor:
    """Integral CV estimator, (B, 1 + nx) f32: the integral kernel for CUDA
    tensors (in-kernel Philox draws, or external ``u01`` (B, rows, 1) and
    ``noise`` (B, rows, nx); the tensor-core kernel in every ``precision``,
    "highest" in six passes), the plain version for CPU tensors. ``lib``:
    another build of ``integral.cu`` (``utils/generate_bench.py``) in place
    of ``INTEGRAL``."""
    check_precision(precision)
    if tx.device.type == "cpu":
        return integral_with_gradients_plain(seed, eq, sol, tx, m, u01,
                                             noise, antithetic=antithetic,
                                             f0=f0, precision=precision)
    _on_card("integral", tx, eq)
    b, nx = tx.shape[0], tx.shape[1] - 1
    _check("tx", tx, (b, 1 + nx), tx.device)
    rows = draw_rows(m, antithetic)
    if (u01 is None) != (noise is None):
        raise ValueError("external noise needs both u01 and noise")
    if noise is not None:
        _check("u01", u01, (b, rows, 1), tx.device)
        _check("noise", noise, (b, rows, nx), tx.device)
    lib = lib or INTEGRAL
    dll = lib.lib()
    mod, n_hidden, scratch = _net_for_launch(dll, "integral", sol, tx, nx,
                                             True)
    t = tx[:, :1].contiguous()
    x = tx[:, 1:].contiguous()
    if f0 is None:
        f0 = get_f(eq, sol, t, x)
    f0 = f0.contiguous()
    _check("f0", f0, (b, 1), tx.device)
    out = torch.empty((b, 1 + nx), dtype=torch.float32, device=tx.device)
    shape = (b, int(m), nx, n_hidden, int(mod is not None), int(antithetic))
    scalars = (_seed(seed), float(eq.T), float(eq.alpha_sqrt), float(eq.k),
               float(eq.ff_offset), _stream(tx.device))
    img, vec, buf = _tc_net(mod, nx, scratch, tx.device,
                            3 if precision == "highest" else 2)
    rc = dll.dpi_integral_tc(
        _ptr(t), _ptr(x), _ptr(f0), _ptr(img), _ptr(vec), _ptr(u01),
        _ptr(noise), _ptr(buf), _ptr(out), *shape,
        _INTEGRAL_MODES[precision], *scalars)
    if rc != 0:
        raise RuntimeError(f"dpi_integral launch failed: error {rc} (CUDA's, "
                           f"or value_mlp_tc.cuh's ERR_* from 10001)")
    lib.count(precision)
    return out


def integral_tc_plan(nx: int, n_hidden: int, precision: str,
                     lib: Optional[CudaLibrary] = None) -> Optional[dict]:
    """The plan the built ``integral.cu`` (``lib``, default ``INTEGRAL``)
    takes at (nx, hidden layers) in ``precision``: as
    ``library_tc_plan``'s. None where nothing fits."""
    out = (ctypes.c_longlong * 5)()
    (lib or INTEGRAL).lib().dpi_integral_tc_plan(
        nx, n_hidden, _INTEGRAL_MODES[check_precision(precision)], out)
    if out[0] < 0:
        return None
    return {"stages": out[0], "save_smem": bool(out[1]),
            "dw_smem": bool(out[2]), "smem_bytes": out[3],
            "scratch_floats": out[4]}


# ---------------------------------------------------------------------------
# standard normal buffer (TPU: _normals_kernel)
# ---------------------------------------------------------------------------

def normals_plain(seed: int, shape, device=None) -> torch.Tensor:
    """Plain version of the normals kernel: ``torch.randn`` on a
    torch.Generator seeded with ``seed`` (f32)."""
    device = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device)


def normals_cuda(seed: int, shape, device,
                 lib: Optional[CudaLibrary] = None) -> torch.Tensor:
    """N(0, 1) f32 buffer of ``shape`` on ``device``: the normals kernel on
    a CUDA device (the value at flat index i depends on (seed, i) alone),
    the plain version on the CPU. ``lib``: another build of ``normals.cu``
    (``utils/normals_bench.py``) in place of ``NORMALS``."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type == "cpu":
        return normals_plain(seed, shape, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty(shape, dtype=torch.float32, device=device)
    ptr = out.data_ptr()
    if ptr % 16:
        raise ValueError("the normals kernel stores 16-byte vectors")
    lib = lib or NORMALS
    rc = lib.lib().dpi_normals(ptr, out.numel(), _seed(seed),
                               _stream(device))
    if rc != 0:
        raise RuntimeError(f"dpi_normals launch failed: CUDA error {rc}")
    lib.count()
    return out


# ---------------------------------------------------------------------------
# K-step Brownian paths (TPU: _paths_kernel in ops/rollout.py)
# ---------------------------------------------------------------------------

class SeedTable:
    """Seeds the rollout kernel reads from device memory, so that a launch
    captured in a CUDA graph draws with a new seed at every replay:
    ``table`` (capacity,) and ``index`` (1,), int64 on ``device``. ``fill``
    copies a list of seeds in (one host-to-device copy) and sets the index
    to 0; each launch with ``seed=`` this table draws with
    ``table[index[0]]``, and the wrapper then advances the index by one
    (an in-stream add, after the kernel)."""

    def __init__(self, capacity: int, device):
        self.table = torch.zeros((int(capacity),), dtype=torch.int64,
                                 device=device)
        self.index = torch.zeros((1,), dtype=torch.int64, device=device)

    def fill(self, seeds) -> None:
        seeds = [int(s) & 0xFFFFFFFFFFFFFFFF for s in seeds]
        if not 0 < len(seeds) <= self.table.numel():
            raise ValueError(f"{len(seeds)} seeds for a table of "
                             f"{self.table.numel()}")
        host = torch.tensor([s - (1 << 64) if s >= 1 << 63 else s
                             for s in seeds], dtype=torch.int64)
        self.table[:len(seeds)].copy_(host)
        self.index.zero_()

    def take(self) -> int:
        """The plain version's read: the seed at the index (a host read),
        then the index advances."""
        seed = int(self.table[int(self.index[0])]) & 0xFFFFFFFFFFFFFFFF
        self.index.add_(1)
        return seed


def paths_plain(seed, x0: torch.Tensor, sqrt_dts: torch.Tensor,
                alpha_sqrt: float, K: int,
                xi: Optional[torch.Tensor] = None):
    """Plain version of the rollout kernel: (xs (K+1, B, nx), xi (K, B,
    nx)) with xs = x0 + cumsum(sqrt_dts sqrt(alpha) xi) over the steps.
    ``xi`` external, or drawn from a torch.Generator seeded with ``seed``:
    an int, or a ``SeedTable``'s entry at its index (which then
    advances)."""
    if isinstance(seed, SeedTable):
        seed = seed.take()
    if xi is None:
        gen = torch.Generator(device=x0.device)
        gen.manual_seed(int(seed))
        xi = torch.randn((int(K),) + tuple(x0.shape), generator=gen,
                         dtype=x0.dtype, device=x0.device)
    steps = sqrt_dts[None] * alpha_sqrt * xi
    xs = torch.cat([x0[None], x0[None] + torch.cumsum(steps, dim=0)], dim=0)
    return xs, xi


def paths_cuda(seed, x0: torch.Tensor, sqrt_dts: torch.Tensor,
               alpha_sqrt: float, K: int,
               out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Exact drift-free K-step paths from x0 (B, nx) with per-row step
    scale sqrt_dts (B, 1) * alpha_sqrt: (xs (K+1, B, nx), xi (K, B, nx))
    f32. The rollout kernel for CUDA tensors (xi[k, b, j] depends on
    (seed, k, b, j) alone), the plain version for CPU tensors. ``seed``:
    an int, or a ``SeedTable`` on x0's device, read by the kernel from
    device memory (so the launch can be captured in a CUDA graph) and
    advanced after it. ``out``: f32 buffers (xs, xi) of those shapes to
    write into and return."""
    if x0.device.type == "cpu":
        xs, xi = paths_plain(seed, x0, sqrt_dts, alpha_sqrt, K)
        if out is None:
            return xs, xi
        for name, buf, v in (("xs", out[0], xs), ("xi", out[1], xi)):
            _check(name, buf, v.shape, x0.device)
            buf.copy_(v)
        return out
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    if x0.dim() != 2 or int(K) < 0:
        raise ValueError(f"x0 must be (B, nx) and K >= 0 (got "
                         f"{tuple(x0.shape)}, K={K})")
    b, nx = x0.shape
    _check("x0", x0, (b, nx), x0.device)
    _check("sqrt_dts", sqrt_dts, (b, 1), x0.device)
    table = seed if isinstance(seed, SeedTable) else None
    if table is not None and not (table.table.device == x0.device
                                  and table.index.device == x0.device):
        raise ValueError(f"the seed table must be on {x0.device}")
    if out is None:
        xs = torch.empty((int(K) + 1, b, nx), dtype=torch.float32,
                         device=x0.device)
        xi = torch.empty((int(K), b, nx), dtype=torch.float32,
                         device=x0.device)
    else:
        xs, xi = out
        _check("xs", xs, (int(K) + 1, b, nx), x0.device)
        _check("xi", xi, (int(K), b, nx), x0.device)
    lib = ROLLOUT.lib()
    smem = lib.dpi_paths_smem_bytes(int(K))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the rollout kernel needs {smem} bytes of shared "
                         f"memory at K={K}, above the block limit of "
                         f"{MAX_SMEM_BYTES}")
    rc = lib.dpi_paths(_ptr(x0), _ptr(sqrt_dts), _ptr(xs), _ptr(xi), b, nx,
                       int(K), _seed(0 if table is not None else seed),
                       None if table is None else _ptr(table.table),
                       None if table is None else _ptr(table.index),
                       0 if table is None else table.table.numel(),
                       float(alpha_sqrt), _stream(x0.device))
    if rc != 0:
        raise RuntimeError(f"dpi_paths launch failed: CUDA error {rc}")
    ROLLOUT.count()
    if table is not None:
        table.index.add_(1)
    return xs, xi


# ---------------------------------------------------------------------------
# PRNG / ELU rate probe (TPU: _probe_kernel in scripts/probe_vpu_roofline.py)
# ---------------------------------------------------------------------------

PROBE_MODES = ("bits", "normals", "elu")


def _probe_mode(which: str) -> int:
    if which not in PROBE_MODES:
        raise ValueError(f"unknown probe mode {which!r} (known: "
                         f"{PROBE_MODES})")
    return PROBE_MODES.index(which)


def probe_grid(which: str) -> int:
    """Blocks of the probe kernel that fill the current card in mode
    ``which``: a multiple of its SM count."""
    grid = PROBE.lib().dpi_probe_grid(_probe_mode(which))
    if grid <= 0:
        raise RuntimeError(f"dpi_probe_grid failed ({grid})")
    return grid


def probe_plain(which: str, seed: int, grid: int, iters: int,
                device=None) -> torch.Tensor:
    """Plain version of the probe kernel: the (grid * 8, 128) partial sums
    of the units drawn by the host Philox (``ops/philox.py``), or, for
    "elu", of the ELU chain on its host normals x0. Host draws cost ~1 s
    per 4M Philox calls, so keep ``grid * iters`` small."""
    from deeppicarditeration_torch.ops import philox

    _probe_mode(which)
    device = torch.device("cpu" if device is None else device)
    rows, lanes = philox.PROBE_ROWS, philox.LANES
    per = philox.PROBE_BLK // rows

    def draws(kind, n_iter):
        u = torch.from_numpy(philox.probe_units(seed, kind, grid, n_iter))
        return u.to(device).reshape(grid, n_iter, rows, per, lanes)

    acc = torch.zeros((grid, rows, lanes), dtype=torch.float32,
                      device=device)
    if which == "elu":
        x0 = draws("normals", 1)[:, 0]
        for _ in range(int(iters)):
            x = x0 + acc[:, :, None, :] * 1e-30
            y = torch.where(x > 0, x, torch.exp(x) - 1.0)
            ge = torch.where(x > 0, torch.ones_like(x), y + 1.0)
            acc = acc + (y * ge).sum(dim=2)
    else:
        units = draws(which, int(iters))
        for i in range(int(iters)):
            acc = acc + units[:, i].sum(dim=2)
    return acc.reshape(grid * rows, lanes)


def probe_cuda(which: str, seed: int, iters: int, device,
               grid: Optional[int] = None) -> torch.Tensor:
    """The rate probe's (grid * 8, 128) partial sums: the probe kernel on a
    CUDA device (``grid`` defaults to ``probe_grid``), the plain version on
    the CPU (``grid`` then required)."""
    device = torch.device(device)
    if device.type == "cpu":
        if grid is None:
            raise ValueError("the plain probe needs an explicit grid")
        return probe_plain(which, seed, grid, iters, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    mode = _probe_mode(which)
    if grid is None:
        grid = probe_grid(which)
    out = torch.empty((grid * 8, 128), dtype=torch.float32, device=device)
    rc = PROBE.lib().dpi_probe(_ptr(out), mode, int(grid), int(iters),
                               _seed(seed), _stream(device))
    if rc != 0:
        raise RuntimeError(f"dpi_probe launch failed: CUDA error {rc}")
    PROBE.count()
    return out


def generate_pis_macs_per_sample(nx: int, hidden, channels: int = 64) -> int:
    """Multiply-adds of the PIS kernel's products per sample (unpadded):
    the gate (S_0..S_L and its head's column 0), the time encoder, the
    net's forward pass to its head and the backward pass of the cotangent
    to the x columns of its input."""
    c, h = channels, list(hidden)
    gate = 2 * c * c + (len(h)) * c * c + c
    enc = 2 * c * c + c * c
    fwd = (c + nx) * h[0] + sum(a * b for a, b in zip(h, h[1:])) \
        + h[-1] * nx
    bwd = nx * h[-1] + sum(a * b for a, b in zip(h, h[1:])) + h[0] * nx
    return gate + enc + fwd + bwd


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
