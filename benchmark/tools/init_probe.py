"""Where `Scenario.__init__`'s seconds go on the card: each step of
`utils.resolve_device` timed in a fresh process, then the CUDA context.

    python3 benchmark/tools/init_probe.py
"""
import json
import os
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])
t = {}
a = time.perf_counter()


def lap(name):
    global a
    now = time.perf_counter()
    t[name] = now - a
    a = now


import torch  # noqa: E402
lap("import torch")
import mplc_tpu_torch  # noqa: E402,F401
lap("import mplc_tpu_torch")
torch.cuda.is_available()
lap("cuda.is_available")
from mplc_tpu_torch.data.datasets import Dataset  # noqa: E402,F401
from mplc_tpu_torch.models.zoo import MODELS  # noqa: E402,F401
from mplc_tpu_torch.scenario import Scenario  # noqa: E402,F401
lap("program_scenario's imports")
from mplc_tpu_torch.parallel import mesh  # noqa: E402
lap("import parallel.mesh")
mesh.world_size()
lap("mesh.world_size")
torch.backends.cudnn.allow_tf32 = False
lap("cudnn.allow_tf32")
torch.backends.cuda.matmul.allow_tf32 = False
lap("matmul.allow_tf32")
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
torch.backends.cudnn.deterministic = True
lap("cudnn.deterministic")
torch.backends.cudnn.benchmark = False
lap("cudnn.benchmark")
torch.use_deterministic_algorithms(True)
lap("use_deterministic_algorithms")
torch.utils.deterministic.fill_uninitialized_memory = False
lap("fill_uninitialized_memory")
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
lap("first CUDA tensor (context)")
from mplc_tpu_torch.utils import resolve_device  # noqa: E402
resolve_device("cuda")
lap("resolve_device again")
print(json.dumps(t, indent=1))
