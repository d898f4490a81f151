"""The port's public calls take the JAX package's arguments.

One case per public top-level function and constant of ``snappy_tpu/``
outside ``ops/pallas/``, found with ``ast`` as the JAX package's files
stand: the port's module of the same path has the name; a function's JAX
positional parameters are the first of the port's, in order, and its JAX
keyword-only ones are keywords of the port's; a constant has the JAX value.
The port's own parameters (``span``) come after, keyword-only, so a JAX call
by position means the same on the port.

Then the calls whose meaning differs by position or name, run on the CPU:
``decode_resolve_batch``'s sixth argument is ``interpret`` (it selects
nothing) and ``use_pallas=False`` is the JAX package's resolution in tensor
ops, each against the JAX call; ``interpret`` of the flat encoder; the CRC's
``blocks``; ``make_mesh``'s axis, whose sharded entries raise where the JAX
ones do; the JAX name of the replay entry; and ``configure`` and
``set_config`` under the JAX field names.
"""

import ast
import importlib
import inspect
import pathlib

import jax
import numpy as np
import pytest
import torch

import snappy_tpu
from snappy_tpu.ops import resolve as jres
from snappy_tpu.parallel import make_mesh as jax_make_mesh
from snappy_tpu.parallel.sharded import sharded_encode_frame_chunks as jax_frame_chunks
from snappy_tpu_torch import config, native
from snappy_tpu_torch.ops import api, crc32c, encode_flat, resolve
from snappy_tpu_torch.parallel import mesh as pmesh
from snappy_tpu_torch.parallel import multihost, sharded
from torch_vectors import (
    hold_jax_native, jax_call_outputs, raw_body, resolve_cases, scan_batch,
    share_cores_with_workers,
)

share_cores_with_workers()
hold_jax_native()

REPO = pathlib.Path(__file__).resolve().parents[1]
P = inspect.Parameter


def _jax_publics():
    """``(port module, name, signature or None)`` of every public top-level
    function and upper-case constant of the JAX package outside
    ``ops/pallas/``; a signature is ``(positional names, keyword-only
    names, *args, **kwargs)``."""
    out = []
    for path in sorted((REPO / "snappy_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "snappy_tpu")
        if rel.parts[:2] == ("ops", "pallas"):
            continue
        parts = ("snappy_tpu_torch", *rel.with_suffix("").parts)
        module = ".".join(parts).removesuffix(".__init__")
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not node.name.startswith("_"):
                    a = node.args
                    out.append((module, node.name, (
                        tuple(x.arg for x in a.posonlyargs + a.args),
                        tuple(x.arg for x in a.kwonlyargs), a.vararg is not None,
                        a.kwarg is not None)))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                out += [(module, t.id, None) for t in targets if isinstance(t, ast.Name)
                        and t.id.isupper() and not t.id.startswith("_")]
    return out


PUBLICS = _jax_publics()


def test_the_comparison_sees_the_jax_package():
    names = {(m, n) for m, n, _ in PUBLICS}
    assert len(PUBLICS) > 150
    assert ("snappy_tpu_torch.ops.resolve", "decode_resolve_batch") in names
    assert ("snappy_tpu_torch.parallel.mesh", "BLOCK_AXIS") in names
    assert not any(".pallas" in m for m, _ in names)


@pytest.mark.parametrize("module,name,jax_sig", PUBLICS, ids=[f"{m}.{n}" for m, n, _ in PUBLICS])
def test_the_port_takes_the_jax_arguments(module, name, jax_sig):
    port = getattr(importlib.import_module(module), name)
    if jax_sig is None:
        jax_module = importlib.import_module(module.replace("snappy_tpu_torch", "snappy_tpu", 1))
        np.testing.assert_array_equal(port, getattr(jax_module, name))
        return
    positional, kwonly, varargs, varkw = jax_sig
    params = list(inspect.signature(port).parameters.values())
    port_pos = [p.name for p in params if p.kind in (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)]
    assert tuple(port_pos[: len(positional)]) == positional
    keywords = {p.name for p in params if p.kind in (P.POSITIONAL_OR_KEYWORD, P.KEYWORD_ONLY)}
    assert set(kwonly) <= keywords
    assert not varargs or any(p.kind == P.VAR_POSITIONAL for p in params)
    assert not varkw or any(p.kind == P.VAR_KEYWORD for p in params)
    # The port's span comes after the JAX parameters, by keyword only.
    assert all(p.kind == P.KEYWORD_ONLY for p in params if p.name == "span")


# --- decode_resolve_batch ---------------------------------------------------------

#: A row with no record (flagged) and a row whose literal is followed by a
#: copy past its end, then one of the JAX resolve tests' contents: the
#: group ``test_torch_resolve_batch.py`` holds to the fused Pallas kernel.
RESOLVE_ROWS = [(b"\x61", 3), (b"\x00a\x1d\x01", 5)]


@pytest.fixture(scope="module")
def resolve_group():
    srcs, _, declens, recs, nops, _ = scan_batch(RESOLVE_ROWS + [raw_body(resolve_cases()[5])])
    port = [torch.from_numpy(x) for x in (srcs, recs, nops.astype(np.int32), declens)]
    return (srcs, recs, nops, declens.astype(np.int64)), port


def _routes(monkeypatch):
    """The resolutions called, in order: the first is the one
    ``decode_resolve_batch`` took (the plain versions of K8 and K9 call
    ``resolve_reference`` in turn)."""
    taken = []
    for name in ("resolve_fh", "resolve", "resolve_reference"):
        real = getattr(resolve, name)
        monkeypatch.setattr(resolve, name, lambda *a, _r=real, _n=name, **k: (
            taken.append(_n), _r(*a, **k))[1])
    return taken


def _same(port_out, jax_out):
    out, fb = (x.numpy() for x in port_out)
    want, want_fb = (np.asarray(x) for x in jax_out)
    np.testing.assert_array_equal(fb, want_fb)
    np.testing.assert_array_equal(out[fb == 0], want[fb == 0])
    return fb


def test_decode_resolve_batch_sixth_argument_is_interpret(resolve_group, monkeypatch):
    """``(..., d_pad, False)`` is ``interpret=False`` in both packages: the
    fused route (K8's plain version here) against the fused Pallas kernel
    in interpret mode, never K9."""
    jargs, args = resolve_group
    taken = _routes(monkeypatch)
    got = resolve.decode_resolve_batch(*args, 1 << 14, False)
    assert taken[0] == "resolve_fh" and "resolve" not in taken
    want = jax_call_outputs(jres.decode_resolve_batch, *jargs, 1 << 14,
                            interpret=True, use_pallas=True, use_fused=True)
    assert _same(got, want).tolist() == [1, 0, 0]


def test_decode_resolve_batch_without_pallas(resolve_group, monkeypatch):
    """``use_pallas=False`` resolves in tensor ops (``resolve_reference``),
    as the JAX package's does in XLA, and gathers with K2."""
    jargs, args = resolve_group
    taken = _routes(monkeypatch)
    got = resolve.decode_resolve_batch(*args, 1 << 14, use_pallas=False)
    assert taken == ["resolve_reference"]
    want = jres.decode_resolve_batch(*jargs, 1 << 14, interpret=True, use_pallas=False)
    _same(got, want)
    taken.clear()
    resolve.decode_resolve_batch(*args, 1 << 14, None, True, False)
    assert taken[0] == "resolve"


def test_decode_resolve_batch_takes_span_by_keyword_only(resolve_group):
    _, args = resolve_group
    seen = []

    def span(name, dev=None):
        seen.append(name)
        return encode_flat._no_span(name)

    resolve.decode_resolve_batch(*args, 1 << 14, span=span)
    assert set(seen) == {"plan", "kernels"}
    with pytest.raises(TypeError):
        resolve.decode_resolve_batch(*args, 1 << 14, None, True, True, span)


# --- the flat encoder, the CRC -----------------------------------------------------

@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(3)
    b = np.zeros((2, 65536), np.uint8)
    b[0, :3000] = np.tile(rng.integers(0, 256, 300, dtype=np.uint8), 10)
    b[1, :700] = rng.integers(0, 4, 700, dtype=np.uint8)
    return torch.from_numpy(b), torch.tensor([3000, 700], dtype=torch.int32)


def test_flat_encoder_interpret_selects_nothing(blocks):
    b, n = blocks
    want = encode_flat.compress_blocks_flat_fast(b, n)
    for got in (encode_flat.compress_blocks_flat_fast(b, n, None),
                encode_flat.compress_blocks_flat_fast(b, n, interpret=True),
                encode_flat.compress_blocks_flat(b, n, None)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(TypeError):
        encode_flat.compress_blocks_flat_fast(b, n, None, encode_flat._no_span)


def test_record_emissions_take_interpret_in_the_jax_place(blocks):
    b, n = blocks
    jw, _ = encode_flat.prepass(b, n)
    rec0, rec1, cnt = encode_flat.parse_blocks(n, jw, b)
    want = encode_flat.records_to_bytes_fused(b, n, rec0, rec1, cnt)
    for got in (encode_flat.records_to_bytes_fused(b, n, rec0, rec1, cnt, None),
                encode_flat.records_to_bytes_fast(b, n, rec0, rec1, cnt, None)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_the_host_wrapper_passes_its_span_through(blocks):
    """A ``span`` bound by position to ``interpret`` would time nothing."""
    b, n = blocks
    seen = []

    def span(name, dev=None):
        seen.append(name)
        return encode_flat._no_span(name)

    encode_flat.compress_blocks_flat_host(b.numpy(), n.numpy(), "cpu", span=span)
    assert {"h2d", "prepass", "kernels", "plan", "d2h"} <= set(seen)


def test_crc_takes_blocks_by_name(blocks):
    b, n = blocks
    want = [native.crc32c_masked(b[i, : n[i]].numpy().tobytes()) for i in range(2)]
    assert crc32c.crc32c_masked_blocks(blocks=b, lengths=n).tolist() == want
    unmasked = crc32c.crc32c_blocks(blocks=b, lengths=n).tolist()
    assert unmasked == [native.crc32c(b[i, : n[i]].numpy().tobytes()) for i in range(2)]


# --- meshes ------------------------------------------------------------------------

def test_make_mesh_names_its_axis():
    devs = [torch.device("cpu")] * 2
    assert pmesh.BLOCK_AXIS == sharded.BLOCK_AXIS == multihost.BLOCK_AXIS == "blocks"
    assert pmesh.make_mesh(devs, "blocks") == pmesh.make_mesh(devs)
    assert pmesh.make_mesh(devs, axis="x").axis == "x"
    assert sharded.sharded_decode_streams_pallas is sharded.sharded_decode_streams_replay


def test_a_mesh_of_another_axis_raises_as_in_jax():
    chunks = np.zeros((2, 65536), np.uint8)
    lens = np.full(2, 100, np.int32)
    with pytest.raises(ValueError):
        jax_frame_chunks(jax_make_mesh(jax.devices("cpu")[:2], "x"), chunks, lens)
    with pytest.raises(ValueError, match="axis"):
        sharded.sharded_encode_frame_chunks(pmesh.make_mesh([torch.device("cpu")] * 2, "x"),
                                            chunks, lens)
    rows, _ = sharded.sharded_encode_frame_chunks(pmesh.make_mesh([torch.device("cpu")] * 2),
                                                  chunks, lens)
    assert rows.shape[0] == 2


# --- configuration -----------------------------------------------------------------

DATA = (REPO / "data" / "html").read_bytes()[:40000]


def test_configure_takes_the_jax_route_names():
    frame = native.frame_compress(DATA)
    api.routes = []
    try:
        with config.configure(device="cpu", pallas_resolve=True) as cfg:
            assert cfg.decode_resolve
            assert api.decompress_frame(frame) == DATA
        assert {r[2] for r in api.routes} == {"resolve"}
    finally:
        api.routes = None
    for theirs, ours in config._REFERENCE_FIELDS.items():
        assert hasattr(snappy_tpu.config.Config(), theirs)
        with config.configure(**{theirs: getattr(config.Config(), ours)}) as cfg:
            assert cfg == config.get_config()


def test_configure_ignores_the_tpu_only_knobs():
    with config.configure(device="cpu"):
        want = (api.compress(DATA), api.compress(DATA, profile="fast"))
    with config.configure(device="cpu", pallas_compose=True, pallas_fastpath="compose",
                          pallas_encode=False) as cfg:
        assert cfg == config.Config(device="cpu")
        assert (api.compress(DATA), api.compress(DATA, profile="fast")) == want


def test_a_jax_name_with_its_port_name_raises():
    with pytest.raises(TypeError, match="pallas_resolve"):
        with config.configure(pallas_resolve=True, decode_resolve=False):
            pass
    with pytest.raises(TypeError, match="unknown"):
        with config.configure(pallas_nothing=True):
            pass
    with pytest.raises(TypeError):
        config.set_config(pallas_flat=False, decode_flat=True)


def test_set_config_takes_the_jax_names():
    base = config.set_config()
    try:
        new = config.set_config(pallas_flat=False, pallas_max_dpad=1 << 18, pallas_compose=True)
        assert (new.decode_flat, new.max_dpad) == (False, 1 << 18)
    finally:
        config.set_config(base)
