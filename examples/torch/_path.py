"""Puts the repository's ``src/`` on ``sys.path`` so that the examples
import ``repro_torch`` when run as scripts (``python
examples/torch/<name>.py``), without ``PYTHONPATH=src``, whose
``sitecustomize.py`` would load jax."""
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without a CUDA "
                             "device) or cpu, to run the plain PyTorch "
                             "versions on the CPU")
