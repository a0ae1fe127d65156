#!/usr/bin/env python3
"""Drive the PyTorch port (`mplc_tpu_torch`) once on one CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):

1. device: torch/CUDA versions and the card's name and power limit;
2. build: every CUDA kernel of the port, one nvcc process per source;
3. slice: the main path through the user entry points, at the MNIST CNN's
   full width: `Scenario(...).run()` with GTG-Shapley (train the grand
   coalition, record it, reconstruct coalitions through K1, evaluate),
   then `Contributivity(sc).exact_reconstructed()` over all 1023
   coalitions of 10 partners. Kernel launch counts are reset just before
   and read just after; every kernel of the path must have launched;
4. reference: the same recording on a small input (Titanic, 3 partners)
   on the card and on the CPU, which must agree;
5. stages: the slice's fit (warm) / record / reconstruct / evaluate
   seconds, each stage synchronized on its own;
6. kernels: each kernel on the main path's own inputs against its plain
   PyTorch version, plus an odd-shaped input; times from CUDA events.

The line before the last two is `{"kernels": [...]}`; then the card's
`nvidia-smi` name and power limit; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mplc_tpu_torch.contrib.contributivity import Contributivity  # noqa: E402
from mplc_tpu_torch.contrib.reconstruct import record_updates  # noqa: E402
from mplc_tpu_torch.contrib.shapley import powerset_order  # noqa: E402
from mplc_tpu_torch.data.datasets import load_mnist, load_titanic  # noqa: E402
from mplc_tpu_torch.ops import cuda_build, recon_kernel  # noqa: E402
from mplc_tpu_torch.scenario import Scenario  # noqa: E402

# Published peaks per card (NVIDIA data sheets, dense): fp32 outside the
# tensor cores (FLOP/s) and device-memory bandwidth (bytes/s).
PEAKS = {"H100 PCIe": (51e12, 2.0e12), "H100 NVL": (60e12, 3.9e12),
         "H100": (67e12, 3.35e12)}

# Tolerance of K1 against its plain version: the same fp32 sum in another
# association (the JAX package's kernel contract, tests/test_recon_kernel.py)
RTOL, ATOL = 1e-4, 1e-5

PARTNERS = 10
SCALE = 0.2     # synthetic MNIST: 12,000 train and 2,000 test samples
NOISE = 0.75    # bench.py's synthetic noise: accuracy must not saturate
DEVICE = "cuda"


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str) -> tuple[float, float]:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise PhaseFailed(f"no published peaks for card {name!r}")


def cuda_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of `fn` over `reps` runs, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mnist_scenario(methods) -> Scenario:
    """bench.py config 1's settings at 10 partners, (i+1)/55 split."""
    total = sum(range(1, PARTNERS + 1))
    return Scenario(PARTNERS, [(i + 1) / total for i in range(PARTNERS)],
                    dataset=load_mnist(scale=SCALE, noise=NOISE),
                    multi_partner_learning_approach="fedavg",
                    aggregation_weighting="data-volume", epoch_count=2,
                    minibatch_count=10, gradient_updates_per_pass_count=8,
                    is_early_stopping=False, methods=methods, seed=0,
                    device=DEVICE)


def phase_slice() -> dict:
    recon_kernel.launches = 0
    t0 = time.perf_counter()
    sc = mnist_scenario(["GTG-Shapley"])
    sc.run()
    gtg = sc.contributivity_list[0]
    exact = Contributivity(sc)
    exact.exact_reconstructed()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = recon_kernel.launches

    recon = exact._reconstructor()
    values = np.array([recon.values[s] for s in powerset_order(PARTNERS)])
    v_all = recon.values[tuple(range(PARTNERS))]
    sv = exact.contributivity_scores
    print(f"[slice] mpl fit score {sc.mpl.history.score:.4f} in "
          f"{sc.mpl.learning_computation_time:.2f} s; v(N) {v_all:.4f}")
    print(f"[slice] GTG-Shapley {np.round(gtg.contributivity_scores, 4).tolist()} "
          f"({gtg.computation_time_sec:.2f} s, recording included)")
    print(f"[slice] exact (reconstructed) {np.round(sv, 4).tolist()} "
          f"({exact.computation_time_sec:.2f} s)")
    print(f"[slice] main path {wall:.2f} s; recon_matmul launches {launches}; "
          f"{recon.reconstructions} coalitions reconstructed; recording "
          f"{json.dumps(recon.recorded.describe())}")
    check(launches > 0, "the main path never launched recon_matmul")
    check(bool(np.isfinite(values).all() and np.isfinite(sv).all()
               and np.isfinite(gtg.contributivity_scores).all()),
          "non-finite values or scores")
    check(len(values) == 2 ** PARTNERS - 1, "not every coalition was valued")
    check(v_all > 0.3, f"v(N) = {v_all} is not above three times chance")
    check(sv[PARTNERS - 1] > sv[0],
          f"partner {PARTNERS - 1} (largest) does not outscore partner 0")
    rec = recon.recorded
    grand = recon_kernel.reconstruct_batch(
        torch.ones(1, PARTNERS, device=DEVICE), rec.init_params, rec.deltas,
        rec.weights)
    err = max((grand[g][k][0] - rec.final_params[g][k]).abs().max().item()
              for g in grand for k in grand[g])
    print(f"[slice] reconstructed grand coalition vs recorded final params: "
          f"max abs err {err:.3g}")
    check(err <= 1e-4, "reconstructed grand coalition differs from the "
                       "recording run's final params")
    return {"launches": launches, "recon": recon}


def phase_reference() -> None:
    """Titanic recording + reconstruction on the card and on the CPU."""
    out = {}
    for device in (DEVICE, "cpu"):
        sc = Scenario(3, [0.2, 0.3, 0.5], dataset=load_titanic(),
                      epoch_count=2, minibatch_count=2,
                      gradient_updates_per_pass_count=2,
                      is_early_stopping=False, seed=0, device=device)
        sc.instantiate_scenario_partners()
        sc.split_data()
        c = Contributivity(sc)
        c.exact_reconstructed()
        rec = c._reconstructor()
        out[device] = (rec, len(sc.dataset.x_test))
    (rg, n_test), (rc, _) = out[DEVICE], out["cpu"]
    err = max((rg.recorded.final_params[g][k].cpu()
               - rc.recorded.final_params[g][k]).abs().max().item()
              for g in rc.recorded.final_params for k in rc.recorded.final_params[g])
    dv = max(abs(rg.values[s] - rc.values[s]) for s in rc.values)
    print(f"[reference] titanic card vs cpu: final params max abs err {err:.3g}, "
          f"v(S) max diff {dv:.4f} (1/n_test {1 / n_test:.4f})")
    # float reassociation moves params by ~1e-6; one test sample at a
    # decision boundary may flip
    check(err <= 1e-4, "card and CPU recordings differ")
    check(dv <= 1.0 / n_test + 1e-6, "card and CPU v(S) differ by more than one sample")


def phase_stages(recon) -> dict:
    """Fit, record, reconstruct and evaluate once more, each synchronized."""
    engine = recon.engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.scenario.mpl.fit()          # warm: the first fit paid CUDA start-up
    fit_s = time.perf_counter() - t0   # fit() ends in a host read of the score
    t0 = time.perf_counter()
    record_updates(engine)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    subsets = powerset_order(PARTNERS)
    width = 64
    masks_all = engine._coalition_arrays(subsets)
    rec_s = eval_s = 0.0
    for i in range(0, len(subsets), width):
        masks = torch.from_numpy(masks_all[i:i + width]).to(DEVICE)
        t0 = time.perf_counter()
        flat = recon_kernel.reconstruct_flat(masks, recon._init, recon._d2,
                                             recon._weights)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            engine.trainer.evaluate_models(
                recon_kernel.unflatten(flat, recon._layout), engine.test)
        torch.cuda.synchronize()
        rec_s += t1 - t0
        eval_s += time.perf_counter() - t1
    stages = {"fit_s": fit_s, "record_s": record_s, "reconstruct_s": rec_s,
              "evaluate_s": eval_s, "coalitions": len(subsets), "width": width}
    print("[stages] " + json.dumps(stages))
    return stages


def kernel_entry(wn2, d2, init, launches, card) -> dict:
    fp32_peak, bandwidth = peaks_for(card)
    B, K = wn2.shape
    D = d2.shape[1]
    got = recon_kernel.fused_contract(wn2, d2, init)
    torch.cuda.synchronize()
    ref = recon_kernel.fused_contract_reference(wn2, d2, init)
    err = (got - ref).abs().max().item()
    check(torch.allclose(got, ref, rtol=RTOL, atol=ATOL),
          f"recon_matmul disagrees with its plain version (max abs err {err})")
    zero = (wn2 == 0).all(dim=1)
    check(bool(zero.any()), "no zero-weight row in the kernel's inputs")
    check(torch.equal(got[zero], init.reshape(1, -1).expand(int(zero.sum()), -1)),
          "a zero-weight coalition does not return init bit-exactly")
    flops = 2 * B * K * D
    nbytes = 4 * (B * K + K * D + D + B * D)
    t_ops, t_bytes = flops / fp32_peak * 1e3, nbytes / bandwidth * 1e3
    ms = cuda_ms(lambda: recon_kernel.fused_contract(wn2, d2, init))
    return {
        "name": "recon_matmul", "route": "cuda",
        "source": "mplc_tpu_torch/csrc/recon_matmul.cu",
        "replaces": "mplc_tpu/ops/recon_kernel.py:130",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "kernel_ms": ms,
        "plain_ms": cuda_ms(lambda: recon_kernel.fused_contract_reference(wn2, d2, init)),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": cuda_ms(lambda: torch.addmm(init.reshape(1, -1), wn2, d2)),
        "shape": {"B": B, "K": K, "D": D}, "flops": flops, "bytes": nbytes,
    }


def phase_kernels(recon, launches, card) -> list:
    """K1 on the main path's own inputs: the recorded stream and a batch of
    64 coalitions (the first 63 of the powerset and the empty coalition,
    whose weights are all zero). Then an odd shape (B=5, K=12, D=22)."""
    subsets = powerset_order(PARTNERS)[:63] + [()]
    masks = torch.from_numpy(recon.engine._coalition_arrays(subsets)).to(DEVICE)
    wn = recon_kernel.normalized_round_weights(masks, recon._weights)
    sums = wn.sum(-1)
    denom = (recon._weights[None] * masks[:, None]).sum(-1)
    check(bool((wn[denom == 0] == 0).all()), "WN rows with zero denominator are not exact zeros")
    check(torch.allclose(sums[denom > 0], torch.ones_like(sums[denom > 0]), rtol=1e-6),
          "WN rows do not sum to 1")
    entry = kernel_entry(wn.reshape(64, -1).contiguous(), recon._d2, recon._init,
                         launches, card)

    g = np.random.default_rng(0)
    odd_wn = g.random((5, 12)).astype(np.float32)
    odd_wn[0] = 0.0
    odd = kernel_entry(*(torch.from_numpy(a).to(DEVICE) for a in (
        odd_wn, g.standard_normal((12, 22)).astype(np.float32),
        g.standard_normal(22).astype(np.float32))), launches, card)
    print(f"[kernels] odd shape B=5 K=12 D=22: max abs err {odd['max_abs_err']:.3g}")
    for e in (entry, odd):
        print(f"[kernels] recon_matmul {e['shape']}: {e['ms']:.4f} ms "
              f"(plain {e['plain_ms']:.4f}, addmm {e['library_ms']:.4f}, "
              f"bound {e['bound_ms']:.4f} by {e['bound_by']})")
    return [entry]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    start = time.perf_counter()
    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")

    t0 = time.perf_counter()
    cuda_build.build([recon_kernel.KERNEL])
    print(f"[build] recon_matmul built in {time.perf_counter() - t0:.2f} s")

    sl = phase_slice()
    phase_reference()
    phase_stages(sl["recon"])
    kernels = phase_kernels(sl["recon"], sl["launches"], card)

    print(f"[done] all phases passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
