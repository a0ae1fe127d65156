"""The PyTorch port stands alone: no file of `mplc_tpu_torch/` or
`chip_smoke.py` imports JAX, optax or the JAX package (not even its
numpy-only modules), nor scikit-learn, which the machine with the card
lacks. The port's environment knobs carry the `MPLC_TORCH_` prefix."""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "mplc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "mplc_tpu", "sklearn")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_found():
    assert len(FILES) > 20
    for name in ("recon_matmul.cu", "recon_matmul_bf16.cu"):
        assert (REPO / "mplc_tpu_torch" / "csrc" / name).exists()
    # the modules the scan below must cover, the precision slice's and the
    # observability base's included
    for module in ("obs/numerics.py", "ops/recon_kernel.py", "constants.py",
                   "contrib/reconstruct.py", "models/zoo.py", "mpl/engine.py",
                   "obs/trace.py", "obs/report.py", "obs/chrome_trace.py",
                   "obs/metrics.py", "obs/flight.py", "obs/analyze_trace.py",
                   "obs/export.py", "parallel/fleet.py", "service/admission.py",
                   "service/packer.py", "service/scheduler.py", "service/router.py",
                   "obs/fleet_view.py", "load_gen.py", "fleet_trace_merge.py",
                   "parallel/mesh.py", "parallel/partner_shard.py", "parallel/launch.py",
                   "drift_diff.py", "tune_coalition_cap.py"):
        assert REPO / "mplc_tpu_torch" / module in FILES, module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_knobs_use_the_port_prefix():
    for path in FILES:
        names = set(re.findall(r"MPLC_[A-Z0-9_]+", path.read_text()))
        assert all(n.startswith("MPLC_TORCH_") for n in names), (path, names)


def test_router_and_fleet_knobs_are_the_ports():
    """The router's and the fleet collector's knobs, named in the modules
    that read them, each with the JAX knob's name under the port's prefix."""
    from mplc_tpu_torch import constants
    want = {"ROUTER_BUDGET_ENV": "MPLC_TORCH_ROUTER_BUDGET",
            "ROUTER_BACKOFF_ENV": "MPLC_TORCH_ROUTER_BACKOFF_SEC",
            "ROUTER_REPIN_OVERLOADS_ENV": "MPLC_TORCH_ROUTER_REPIN_OVERLOADS",
            "ROUTER_FAULT_PLAN_ENV": "MPLC_TORCH_ROUTER_FAULT_PLAN",
            "ROUTER_SERVE_ENV": "MPLC_TORCH_ROUTER_SERVE",
            "FLEET_PEERS_ENV": "MPLC_TORCH_FLEET_PEERS"}
    assert {k: getattr(constants, k) for k in want} == want
    port = REPO / "mplc_tpu_torch"
    for module, knobs in (("service/router.py", ("ROUTER_BUDGET_ENV", "ROUTER_BACKOFF_ENV",
                                                 "ROUTER_REPIN_OVERLOADS_ENV")),
                          ("faults.py", ("ROUTER_FAULT_PLAN_ENV",)),
                          ("obs/export.py", ("ROUTER_SERVE_ENV",)),
                          ("obs/fleet_view.py", ("FLEET_PEERS_ENV",))):
        text = (port / module).read_text()
        assert all(k in text for k in knobs), module
