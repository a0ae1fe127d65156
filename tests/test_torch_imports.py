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
                   "obs/metrics.py", "obs/flight.py", "obs/analyze_trace.py"):
        assert REPO / "mplc_tpu_torch" / module in FILES, module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_knobs_use_the_port_prefix():
    for path in FILES:
        names = set(re.findall(r"MPLC_[A-Z0-9_]+", path.read_text()))
        assert all(n.startswith("MPLC_TORCH_") for n in names), (path, names)
