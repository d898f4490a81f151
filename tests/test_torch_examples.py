"""The port's examples (``snappy_tpu_torch.examples``) against the JAX
package's (``examples/``), each run as a process of its own on the CPU.

The stream examples run here on the host codec (``SNAPPY_TPU_ENGINE=native``)
and must print the JAX examples' bytes on the same stdin or argument; named
no engine, they take the card, and without one exit with a message. The GPU pipeline runs here on a mesh of four CPU entries
(``SNAPPY_TPU_FORCE_CPU=1``, the hosted tensor decode): its decoded rows
must equal the JAX package's ``sharded_decode_streams_hosted`` on four of
the JAX CPU devices, and its two losses and final table the JAX example's
``loss_fn`` and ``jax.value_and_grad`` step recomputed on those rows
(rtol 1e-5, atol 1e-8: float32 sums over every byte of a shard, which the
port takes grouped by byte value, in another order).
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu import native as jnative
from snappy_tpu.ops.packing import batch_streams, pad_to_bucket
from snappy_tpu.parallel import make_mesh as jax_mesh
from snappy_tpu.parallel.sharded import sharded_decode_streams_hosted
from snappy_tpu_torch import native
from snappy_tpu_torch.examples import gpu_pipeline
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARD = 256 * 1024
STDIN = load_corpus("alice29.txt") + bytes(70000) + load_corpus("fireworks.jpeg")[:30000]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SNAPPY_TPU_")}
    return {**env, "PYTHONPATH": REPO, **extra}


def _port(name, *args, stdin=b"", **env):
    """The port's example on the host codec, unless ``env`` says otherwise:
    the examples take the card when the environment names no engine."""
    env = {"SNAPPY_TPU_ENGINE": "native", **env}
    return subprocess.run([sys.executable, "-m", f"snappy_tpu_torch.examples.{name}", *args],
                          input=stdin, capture_output=True, cwd=REPO,
                          env={k: v for k, v in _env(**env).items() if v is not None})


def _jax(name, *args, stdin=b""):
    return subprocess.run([sys.executable, os.path.join(REPO, "examples", f"{name}.py"), *args],
                          input=stdin, capture_output=True, cwd=REPO,
                          env=_env(JAX_PLATFORMS="cpu"))


def test_compress_equals_the_jax_example_and_decompress_round_trips():
    mine, theirs = _port("compress", stdin=STDIN), _jax("compress", stdin=STDIN)
    assert mine.returncode == 0 and theirs.returncode == 0, mine.stderr + theirs.stderr
    assert mine.stdout == theirs.stdout == native.frame_compress(STDIN)
    back = _port("decompress", stdin=mine.stdout)
    assert back.returncode == 0 and back.stdout == STDIN


@pytest.mark.parametrize("name,args", [("compress", ()), ("decompress", ()),
                                       ("compress_escaped", ("abc",))])
def test_stream_examples_take_the_card_unless_an_engine_is_named(name, args):
    stdin = native.frame_compress(b"abc" * 30000) if name == "decompress" else b"abc" * 30000
    r = _port(name, *args, stdin=stdin, SNAPPY_TPU_ENGINE=None, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0 and b"no CUDA device" in r.stderr


@pytest.mark.parametrize("arg", ["hello\tworld 'quoted' \"x\" \\", "abc" * 40])
def test_compress_escaped_prints_the_jax_examples_lines(arg):
    mine, theirs = _port("compress_escaped", arg), _jax("compress_escaped", arg)
    assert mine.returncode == 0 and mine.stdout == theirs.stdout
    assert len(mine.stdout.decode().splitlines()) == 2


def test_pipeline_runs_on_four_cpu_entries_when_asked():
    r = _port("gpu_pipeline", SNAPPY_TPU_FORCE_CPU="1", PIPELINE_SHARD_BYTES=str(SHARD))
    out = r.stdout.decode()
    assert r.returncode == 0, r.stderr.decode()
    assert out.splitlines()[0] == "mesh: 4 x cpu" and "step 1: loss " in out
    assert out.splitlines()[-1] == "pipeline ok"


def test_pipeline_without_a_card_or_the_cpu_request_exits_with_a_message():
    r = _port("gpu_pipeline", CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0 and b"no CUDA device" in r.stderr and b"pipeline ok" not in r.stdout


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "tpu_pipeline", os.path.join(REPO, "examples", "tpu_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cpu_run():
    return gpu_pipeline.run("cpu", SHARD)


def test_pipeline_rows_equal_the_jax_hosted_decode(cpu_run):
    """The JAX example's CPU route, step by step: its frame walk, the host's
    op-start bitmaps, and the sharded hosted decode on four JAX devices."""
    _, _, rows = cpu_run
    walk = _jax_example().split_frame
    mesh = jax_mesh(jax.devices()[:4])
    for (wire, plain), (got, nbytes) in zip(gpu_pipeline.make_shards(SHARD), rows):
        bodies = [(b, d) for k, d, b in walk(wire) if k == 0]
        width = pad_to_bucket(max(len(b) for b, _ in bodies))
        srcs, lens = batch_streams([b for b, _ in bodies], width)
        declens = np.array([d for _, d in bodies], np.int32)
        bits = np.zeros((len(bodies), width // 8), np.uint8)
        jnative.scan_ops_batch(srcs, lens.astype(np.uint64), bits)
        pb = -(-len(bodies) // 4) * 4
        pad = lambda a: np.pad(a, [(0, pb - len(a))] + [(0, 0)] * (a.ndim - 1))  # noqa: E731
        out, errc, out_len = sharded_decode_streams_hosted(
            mesh, pad(srcs), pad(lens), pad(declens), pad(bits), 65536)
        n = len(bodies)
        assert not np.asarray(errc).any()
        assert np.array_equal(got.numpy(), np.asarray(out)[:n])
        assert np.array_equal(nbytes.numpy(), np.asarray(out_len)[:n])
        assert b"".join(got[i, : int(nbytes[i])].numpy().tobytes() for i in range(n)) == plain


def test_pipeline_losses_and_params_equal_the_jax_step(cpu_run):
    losses, params, rows = cpu_run
    p = jnp.asarray(np.random.default_rng(0).standard_normal((256, 16)) * 0.01, jnp.float32)

    def loss_fn(p, tokens, mask):  # examples/tpu_pipeline.py's loss
        h = jnp.mean(p[tokens.astype(jnp.int32)], axis=-1)
        return jnp.sum(h * h * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    want = []
    for tokens, nbytes in rows:
        t = jnp.asarray(tokens.numpy())
        mask = (jnp.arange(t.shape[1])[None, :] < jnp.asarray(nbytes.numpy())[:, None]).astype(
            jnp.float32)
        loss, grad = jax.value_and_grad(loss_fn)(p, t, mask)
        p = p - 0.1 * grad
        want.append(float(loss))
    assert len(losses) == 2 and losses[0] != losses[1]
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(params.numpy(), np.asarray(p), rtol=1e-5, atol=1e-8)
    assert not torch.equal(params, gpu_pipeline.ByteEmbedding().table.detach())
