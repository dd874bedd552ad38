"""The benchmark's own tests: CPU, small sizes. A test that needs the card
is marked ``cuda`` and skips without one."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny_files(config: str, traffic: str, limits: str) -> dict:
    """The small cells' files: a small copy of a preset, a small traffic mix
    and limits read from such runs (``data/README``)."""
    return {"config": DATA / f"{config}.json", "traffic": DATA / f"traffic_{traffic}.json",
            "limits": DATA / f"limits_{limits}.json"}
