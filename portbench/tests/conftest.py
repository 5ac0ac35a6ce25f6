"""The benchmark's CPU tests import the port from `src/` and the
benchmark from the checkout's root."""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(1)
