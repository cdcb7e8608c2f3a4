#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py                   # the main path for 3 iterations
    python3 chip_smoke.py --iterations 100  # the recipe's full Picard budget

Phases (each failure exits non-zero; the result line is printed last, and
only when every phase passed):
  1. build the path's CUDA kernel from ``deeppicarditeration_torch/csrc``;
  2. the merged estimator kernel against its plain PyTorch version on the
     same external noise, at full width (nx=100, 4x128 ELU, B=256,
     M=4096), for the zero iterate and for a random net;
  3. the kernel's in-kernel Philox normals against the plain version's
     torch.Generator normals (B=64): within 5 CLT standard errors per
     output, and a mean squared z-score near 1;
  4. the main path: the Burgers 100-d w1.0 recipe (the dict below equals
     configs/burgers/base_100d_T1.0_w1.0.yaml with its BASE chain; a CPU
     test holds it to the YAML) through ``PicardRunner`` at full width
     for PICARD.N = 3 iterations (``--iterations``), with the kernel
     launch count read around the run;
  5. at the main path's shapes (B=4096 points from its sampler, M=4096)
     and with its zero and trained iterates: the kernel against the plain
     version on the same external noise, and its Philox draws against
     torch.Generator draws (a Bonferroni CLT bound over all outputs);
     then kernel and plain-version times and the kernel's bound, printed
     as one ``{"kernels": [...]}`` JSON line.
Needs one NVIDIA H100 SXM card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# configs/burgers/base_100d_T1.0_w1.0.yaml with its BASE chain resolved
BURGERS_W1_RECIPE = {
    "NAME": "Cha5.0_NoEnT_100D_T1.0_w0.0_DS4096_M4096_E16_w1.0",
    "FORCE": True,
    "EQUATION": {"cls": "Cha",
                 "kwargs": {"nx": 100, "alpha": 1.0, "k": 5.0, "T": 1.0}},
    "METHOD": {"cls": "Picard"},
    "PICARD": {"N": 100},
    "DATA": {"DATA_SIZE": 4096,
             "kwargs": {"t_always_uniform": True,
                        "n_estimate_terminal": 4096,
                        "n_estimate_integral": 4096},
             "CHUNK_ELEMS": 33554432,
             "SAMPLE_BOUND": 2.0},
    "TRAIN": {"N_EPOCHS": 16, "BATCH_SIZE": 512, "SUPERVISE_GRADIENT": True,
              "LOSS": {"beta": 0.0,
                       "SCALER": {"cls": "FixedLossScaler",
                                  "kwargs": {"fixed_weight": 1.0}}}},
    "NETWORK": {"cls": "PicardSolution", "NEURONS": [128, 128, 128, 128],
                "ACTIVATIONS": ["ELU", "ELU", "ELU", "ELU"], "BOUND": None,
                "RELOAD": True},
    "EVAL": {"L2_N_POINTS": 10000, "FREQ": 8, "TEST_GRAD": True},
}

TOL = 5e-5  # kernel vs plain on the same noise: rtol = atol
CLT_SIGMAS = 5.0  # per output, phase 3
CLT_FAMILY_P = 1e-3  # chance of a false failure over all outputs, phase 5
Z2_BAND = (0.8, 1.25)  # mean (|diff|/SE)^2, 1 expected
RRMSE_MAX = 0.35

# NVIDIA's data sheet for the H100 SXM (dense, at 700 W): FP32 FLOP/s
# outside the tensor cores, and HBM3 bytes/s
H100_SXM = "H100 80GB HBM3"
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def burgers_w1_cfg(n_iter: int, device: str = "cuda"):
    from deeppicarditeration_torch.config import default_cfg

    cfg = default_cfg()
    cfg.merge(BURGERS_W1_RECIPE, allow_new=False)
    cfg.PICARD.N = n_iter
    cfg.DEVICE = device
    return cfg.freeze()


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _same_noise(label, eq, sol, tx, m, u01, nt, ni) -> float:
    """Kernel vs plain version on the same external noise; fails on a
    mismatch, else returns the max |diff|."""
    import torch

    from deeppicarditeration_torch.ops import kernels

    out = kernels.generate_with_gradients_cuda(0, eq, sol, tx, m, u01, nt, ni)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, u01, nt,
                                                ni)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    ok = bool((err <= TOL + TOL * ref.abs()).all())
    print(f"kernel vs plain ({label}, B={tx.shape[0]} M={m} "
          f"nx={tx.shape[1] - 1}): max |diff| {float(err.max()):.3e}, "
          f"within rtol=atol={TOL}: {ok}")
    if not ok or not torch.isfinite(out).all():
        _fail(f"kernel disagrees with its plain version ({label})")
    return float(err.max())


def _clt(label, out, ref, var, m, bound) -> None:
    """In-kernel draws vs torch.Generator draws: every |diff| within
    ``bound`` standard errors, and a mean squared z-score in Z2_BAND."""
    import torch

    z = (out - ref).abs() / torch.sqrt(2.0 * var / m).clamp(min=1e-12)
    zmax, z2 = float(z.max()), float((z * z).mean())
    print(f"Philox vs torch.Generator ({label}, B={out.shape[0]} M={m}): "
          f"max |diff|/SE {zmax:.2f} (bound {bound:.2f}), mean "
          f"(|diff|/SE)^2 {z2:.3f} (band {Z2_BAND})")
    if not (zmax < bound and Z2_BAND[0] <= z2 <= Z2_BAND[1]
            and torch.isfinite(out).all()):
        _fail(f"in-kernel draws disagree with the plain version's law "
              f"({label})")


def _problem(b, m, nx, net, seed, device):
    import torch

    from deeppicarditeration_torch.equations import make_equation
    from deeppicarditeration_torch.models.networks import MLP
    from deeppicarditeration_torch.models.solution import Solution

    g = torch.Generator().manual_seed(seed)
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    sol = Solution.zero(nx)
    if net:
        mod = MLP(1 + nx, (128,) * 4, ("ELU",) * 4, 1, generator=g)
        sol = Solution.from_net(mod.to(device), "Value", nx)
    t = torch.rand((b, 1), generator=g) * 0.99 + 0.005
    x = torch.randn((b, nx), generator=g) * t.sqrt()
    return eq, sol, torch.cat([t, x], 1).to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iterations", type=int, default=3,
                    help="Picard iterations of the main path (default 3)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not (ROOT / "deeppicarditeration_torch" / "csrc").is_dir():
        print(f"chip_smoke: no deeppicarditeration_torch package beside "
              f"{ROOT / 'chip_smoke.py'}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deeppicarditeration_torch.device import make_generator
    from deeppicarditeration_torch.models.solution import Solution
    from deeppicarditeration_torch.ops import estimators as est
    from deeppicarditeration_torch.ops import kernels
    from deeppicarditeration_torch.training.picard import (
        PicardRunner,
        gen_config_from_cfg,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    if H100_SXM not in name:
        _fail(f"the bound uses the peaks of the H100 SXM ({H100_SXM!r}); "
              f"this card is {name!r}")

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernels.GENERATE
    lib.lib()
    info = [ln.strip() for ln in lib.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s; {lib.so_path.name}; "
          + " | ".join(info))

    # ---- 2. kernel vs plain, same external noise, full width ---------------
    b, m, nx = 256, 4096, 100
    max_err = 0.0
    for net in (False, True):
        eq, sol, tx = _problem(b, m, nx, net, 1, dev)
        g = torch.Generator(device=dev).manual_seed(2)
        u01 = torch.rand((b, m, 1), generator=g, device=dev)
        nt = torch.randn((b, m, nx), generator=g, device=dev)
        ni = torch.randn((b, m, nx), generator=g, device=dev)
        max_err = max(max_err, _same_noise(
            "random net" if net else "zero iterate", eq, sol, tx, m, u01,
            nt, ni))
        del u01, nt, ni

    # ---- 3. in-kernel Philox vs torch.Generator noise (CLT) ---------------
    eq, sol, tx = _problem(64, m, nx, True, 3, dev)
    out = kernels.generate_with_gradients_cuda(20261016, eq, sol, tx, m)
    ref, var = kernels.generate_with_gradients_plain(7, eq, sol, tx, m,
                                                     return_var=True)
    _clt("random net", out, ref, var, m, CLT_SIGMAS)

    # ---- 4. the main path --------------------------------------------------
    n_iter = args.iterations
    cfg = burgers_w1_cfg(n_iter)
    runner = PicardRunner(cfg, exp_root=ROOT / "build" / "chip_smoke_runs")
    kernels.GENERATE.launches = 0
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.GENERATE.launches
    rows = [json.loads(ln) for ln in
            (runner.exp_dir / "metrics.jsonl").read_text().splitlines()]
    final = {}
    for r in rows:
        if r["context"] == "eval":
            final[int(r["iter"])] = r
    for tm in runner.timings:
        ev = final.get(tm["iter"], {})
        print(f"iteration {tm['iter']}: generate {tm['generate_ms']:.1f} ms"
              f", fit {tm['fit_ms']:.1f} ms, rRMSE {ev.get('rRMSE')}, "
              f"rRMSEg {ev.get('rRMSEg')}, kernel launches "
              f"{launches / n_iter:g}/iteration")
    print(f"main path: {n_iter} iterations in {wall:.1f} s; kernel launches "
          f"{launches}, generation calls {runner.generate_calls}")
    steady = [tm for tm in runner.timings if tm["iter"] > 1]
    if len(steady) >= 2:
        for key in ("generate_ms", "fit_ms"):
            v = [tm[key] for tm in steady]
            q = statistics.quantiles(v, n=4)
            print(f"steady state (iterations 2-{n_iter}): {key} median "
                  f"{statistics.median(v):.1f}, quartiles {q[0]:.1f}-"
                  f"{q[2]:.1f}")
    curve = [final[i]["rRMSE"] for i in sorted(final)]
    if curve:
        last = final[max(final)]
        print(f"final rRMSE {last['rRMSE']}, rRMSEg {last['rRMSEg']}; mean "
              f"rRMSE of the last {min(10, len(curve))} iterations "
              f"{statistics.mean(curve[-10:])}")
    if launches != runner.generate_calls or launches == 0:
        _fail("the main path did not generate through the kernel")
    for i in range(1, n_iter + 1):
        r = final.get(i, {}).get("rRMSE")
        if r is None or not math.isfinite(r) or r > RRMSE_MAX:
            _fail(f"iteration {i} rRMSE {r} (want finite and <= "
                  f"{RRMSE_MAX})")

    # ---- 5. the main path's shapes: same noise, law, times, bound ----------
    eq, sol = runner.equation, runner.u_current  # the trained iterate
    gen = gen_config_from_cfg(cfg)
    nb, mm = int(cfg.DATA.DATA_SIZE), gen.n_estimate_terminal
    tx = est.sample_tx(make_generator(dev, 4), eq, nb, gen, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    u01 = torch.rand((nb, mm, 1), generator=g, device=dev)
    nt = torch.randn((nb, mm, nx), generator=g, device=dev)
    ni = torch.randn((nb, mm, nx), generator=g, device=dev)
    for label, s in (("zero iterate", Solution.zero(nx)),
                     (f"iterate {n_iter}", sol)):
        max_err = max(max_err, _same_noise(label, eq, s, tx, mm, u01, nt,
                                           ni))
    del u01, nt, ni
    out = kernels.generate_with_gradients_cuda(5, eq, sol, tx, mm)
    ref, var = kernels.generate_with_gradients_plain(7, eq, sol, tx, mm,
                                                     return_var=True)
    n_out = out.numel()
    _clt(f"iterate {n_iter}", out, ref, var, mm,
         statistics.NormalDist().inv_cdf(1 - CLT_FAMILY_P / (2 * n_out)))
    del out, ref, var
    ms = _time_ms(lambda: kernels.generate_with_gradients_cuda(
        5, eq, sol, tx, mm), 3)
    plain_ms = _time_ms(lambda: kernels.generate_with_gradients_plain(
        5, eq, sol, tx, mm), 2)
    n_hidden = len(sol.module.neurons)
    flops = nb * mm * kernels.generate_flops_per_sample(
        nx, sol.module.neurons)
    n_weights = sum(p.numel() for p in sol.module.parameters())
    n_bytes = 4 * (nb * (1 + nx + 2) + n_weights + nb * (1 + nx))
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    print(f"generate at B={nb} M={mm}: kernel {ms:.2f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s FP32 on the net), plain "
          f"{plain_ms:.1f} ms, bound {max(t_ops, t_bytes):.2f} ms "
          f"({flops:.3e} FP32 operations, {n_hidden}x128 net; "
          f"{2 * nb * mm * nx:.3e} normals)")
    line = {"kernels": [{
        "name": "generate_with_gradients",
        "route": "cuda",
        "source": "deeppicarditeration_torch/csrc/generate.cu",
        "replaces": "deeppicarditeration_tpu/ops/pallas_kernels.py:869",
        "launches": launches,
        "launches_per_iteration": launches / n_iter,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
