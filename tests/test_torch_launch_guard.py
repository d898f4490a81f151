"""Every kernel launch runs on its tensors' own card.

A C entry of ``csrc/`` launches on the current CUDA device and keys its
per-card caches by it, so a wrapper handed tensors on another card must
make that card current around the call. Every wrapper launches through
``ops._build.launch``, which does so and passes that card's current
stream; a rank of ``multihost`` makes its own card current before it
joins its process group. Here, with no card, the CUDA device guard and
streams are replaced by recorders."""

import datetime
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import snappy_tpu_torch.ops as ops_pkg
from snappy_tpu_torch.config import configure
from snappy_tpu_torch.ops import _build
from snappy_tpu_torch.parallel import multihost

OPS = Path(ops_pkg.__file__).parent
KERNEL_MODULES = sorted(p.stem for p in OPS.glob("*.py")
                        if "kernel_lib(" in p.read_text() and p.stem != "_build")


@pytest.fixture
def guards(monkeypatch):
    """Replace ``torch.cuda.device`` and ``current_stream`` with recorders:
    the list holds each device entered and ``None`` at each exit."""
    entered = []

    class Guard:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.append(None)

    class Stream:
        def __init__(self, device):
            self.cuda_stream = 1000 + torch.device(device).index

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    return entered


@pytest.mark.parametrize("index", [0, 1, 3])
def test_a_launch_runs_with_its_card_current_and_its_stream(guards, index):
    card = torch.device("cuda", index)
    calls = []

    def entry(*args):
        assert guards == [card], "the C entry ran outside its card's guard"
        calls.append(args)
        return 0

    _build.launch(card, "k", entry, 7, 8)
    assert calls == [(7, 8, 1000 + index)]
    assert guards == [card, None]
    with pytest.raises(RuntimeError, match="k: CUDA launch failed with error 2"):
        _build.launch(card, "k", lambda *args: 2)
    assert guards == [card, None, card, None]


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_every_wrapper_launches_through_the_guard(module):
    """A wrapper that loads a kernel library calls its entries only through
    ``_build.launch``: it takes no stream of its own and checks no status
    itself."""
    src = (OPS / f"{module}.py").read_text()
    assert "_build.launch(" in src
    for bypass in ("current_stream", "cuda_stream", "getCurrentRawStream", "_build.check("):
        assert bypass not in src, f"{module}.py launches around the guard ({bypass})"


@pytest.mark.parametrize("local_rank", [0, 2, 5])
def test_a_rank_makes_its_own_card_current_before_it_joins(monkeypatch, local_rank):
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(("join", kw["backend"])))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for var, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1"), ("WORLD_SIZE", "4"),
                       ("RANK", str(local_rank)), ("LOCAL_RANK", str(local_rank))):
        monkeypatch.setenv(var, value)
    multihost.initialize(timeout=datetime.timedelta(seconds=3))
    assert calls == [("set_device", torch.device("cuda", local_rank % 4)), ("join", "nccl")]
    calls.clear()
    with configure(device="cpu"):
        multihost.initialize()
    assert calls == [("join", "gloo")]
