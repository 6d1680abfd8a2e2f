"""The benchmark's own tests: ``python -m pytest omnibench/tests`` from the
root of the repository.  Tests marked ``card`` need a CUDA card and skip
without one, deciding inside the ``card`` fixture; on the card:
``python -m pytest omnibench/tests -m card``."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")
    return torch.device("cuda")
