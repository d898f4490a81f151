"""K5's walk (``emit.fused_emit_walk``, the kernel's steps in numpy) gives
the plain version's source indices (``emit.shift_idx_plain``).

The kernel walks each row in runs of groups, a few groups a step, keeps
the plan rows the step's windows cover in a ring, takes their deltas into a
running exclusive prefix, and finds each byte's steps by two binary
searches and a count: all of which relies on the plan's breakpoints being
sorted within a window. The plain version takes the windowed sum with no
order assumed, so equal indices here show that the order the kernel relies
on holds, on the batches of ``test_torch_encode_flat.py``, an all-padding
batch and a row whose ``out_len`` ends part way through a group. The
plain version is itself held to the JAX package's ``shift_idx_pallas`` in
``test_torch_encode_flat.py``. Indices are integers: equality.
"""

import pytest
import torch

from conftest import load_corpus
from snappy_tpu_torch.ops import emit, encode_flat, parse
from test_torch_encode_flat import BATCHES, _blocks
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()


def _plan(datas):
    blocks, lens = _blocks(datas)
    bt, lt = torch.from_numpy(blocks), torch.from_numpy(lens)
    jw, _ = encode_flat.prepass(bt, lt)
    rec = parse.parse_blocks(lt, jw, bt)
    *plan, _, ovf = encode_flat._fused_plan(bt, lt, *rec)
    assert not ovf.any()
    return plan


@pytest.fixture(scope="module", params=sorted(BATCHES))
def batch_plan(request):
    return _plan(BATCHES[request.param]())


def test_walk_matches_plain_on_the_encode_flat_batches(batch_plan):
    assert torch.equal(emit.fused_emit_walk(*batch_plan), emit.shift_idx_plain(*batch_plan))


@pytest.mark.parametrize("ring, step, run", [(14, 4, 16), (16, 2, 5), (32, 4, 80), (14, 8, 8)])
def test_walk_matches_plain_with_other_rings_and_steps(batch_plan, ring, step, run, monkeypatch):
    """Other ring sizes, groups a step and runs: steps cut short where the
    windows overrun the ring, rings started afresh, runs that start part
    way through a row."""
    monkeypatch.setattr(emit, "RING_ROWS", ring)
    monkeypatch.setattr(emit, "STEP_GROUPS", step)
    monkeypatch.setattr(emit, "RUN_GROUPS", run)
    assert torch.equal(emit.fused_emit_walk(*batch_plan), emit.shift_idx_plain(*batch_plan))


def test_walk_on_an_all_padding_batch():
    plan = _plan([b""] * 4)
    assert not plan[3].any()
    idx = emit.fused_emit_walk(*plan)
    assert not idx.any() and torch.equal(idx, emit.shift_idx_plain(*plan))


def test_walk_on_a_row_ending_part_way_through_a_group():
    data = load_corpus("alice29.txt")[:30000]
    plan = _plan([b"", data, b"", bytes(range(256)) * 40])
    olen = int(plan[3][1])
    assert olen % emit.GROUP  # the row's last live group is cut short
    idx = emit.fused_emit_walk(*plan)
    assert torch.equal(idx, emit.shift_idx_plain(*plan))
    live = -(-olen // emit.GROUP) * emit.GROUP
    assert idx[1, olen:live].any() and not idx[1, live:].any() and not idx[[0, 2]].any()


def test_walk_reads_the_steps_in_order():
    """A window whose breakpoints are out of order: the plain version still
    sums every step at or below each byte, the kernel's walk (which relies
    on the order) gives other indices, so the equality above is a check of
    the plan's order and not a tautology."""
    plan = [x.clone() for x in _plan([load_corpus("alice29.txt")[:20000]])]
    bp = plan[4].view(1, -1)
    live = int((bp < int(plan[3][0])).sum())
    assert live > 64
    bp[0, :64] = bp[0, :64].flip(0)
    assert not torch.equal(emit.fused_emit_walk(*plan), emit.shift_idx_plain(*plan))
