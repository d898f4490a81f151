"""``Config.flat_encode`` selects the encoder of ``compress(profile="fast")``
as the JAX package's field of the same name does, on the CPU.

Under ``True`` the port's ``compress(..., profile="fast", device="cpu")``
(the flat encoder's plain versions) and ``raw.Encoder("device-fast")``
must give ``snappy_tpu.ops.api.compress(..., profile="fast")``'s bytes
under ``True``; under ``False`` (the fast profile in tensor ops) its bytes
under ``False``. Under ``None`` the port takes the flat encoder, as the JAX
package does on its TPU; off a TPU the JAX package's ``None`` takes the
XLA profile, so the port is held to its ``True``. Bytes: equality.
"""

import dataclasses

import pytest

import snappy_tpu
from conftest import load_corpus
from snappy_tpu import raw as jraw
from snappy_tpu.config import Config as JConfig
from snappy_tpu.ops import api as japi
from snappy_tpu_torch import native, raw
from snappy_tpu_torch.config import Config, config_from_reference, configure
from snappy_tpu_torch.ops import api
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

SLICES = {
    "alice29": load_corpus("alice29.txt")[:40000],
    "kppkn": load_corpus("kppkn.gtb")[:30000],
}


@pytest.mark.parametrize("name", sorted(SLICES))
@pytest.mark.parametrize("flat_encode", [None, True, False])
def test_fast_profile_follows_flat_encode(flat_encode, name):
    data = SLICES[name]
    jax_setting = True if flat_encode is None else flat_encode
    with snappy_tpu.configure(flat_encode=jax_setting):
        want = japi.compress(data, profile="fast")
        want_engine = jraw.Encoder("device-fast").compress_vec(data)
    with configure(device="cpu", flat_encode=flat_encode):
        got = api.compress(data, profile="fast")
        got_engine = raw.Encoder("device-fast").compress_vec(data)
    assert got == want and got_engine == want_engine == want
    assert native.decompress(got) == data


def test_the_two_encoders_differ_on_alice():
    """The selector is visible: the two profiles give different streams."""
    data = SLICES["alice29"]
    with configure(device="cpu", flat_encode=True):
        flat = api.compress(data, profile="fast")
    with configure(device="cpu", flat_encode=False):
        tensor = api.compress(data, profile="fast")
    assert flat != tensor
    assert native.decompress(flat) == native.decompress(tensor) == data


@pytest.mark.parametrize("flat_encode", [None, True, False])
def test_config_from_reference_carries_flat_encode(flat_encode):
    cfg = config_from_reference(dataclasses.asdict(JConfig(flat_encode=flat_encode)))
    assert cfg == Config(flat_encode=flat_encode)
