"""The environment layer of the port's configuration: the JAX package's
twelve ``SNAPPY_TPU_*`` variables steer ``snappy_tpu_torch.get_config()``
as they steer ``snappy_tpu.config.get_config()``, over every programmatic
setting, and ``get_engine("auto")`` resolves to the same engine in both
packages. Equality throughout: the fields are flags, names and counts."""

import dataclasses

import pytest

from snappy_tpu import config as jconfig
from snappy_tpu import engine as jengine
from snappy_tpu_torch import config as C
from snappy_tpu_torch import engine
from snappy_tpu_torch.format import reference as ref
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops.api import decompress_streams
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

#: Every variable of the JAX package's ``_ENV_KNOBS``, each with values that
#: turn it on, off, leave it empty and give it a malformed value.
VALUES = {
    "SNAPPY_TPU_ENGINE": ("device", "reference", "", "no-such-engine"),
    "SNAPPY_TPU_THREADS": ("3", "0", "", "many"),
}
BOOLEAN = (
    "SNAPPY_TPU_PALLAS_DECODE", "SNAPPY_TPU_PALLAS_FLAT", "SNAPPY_TPU_PALLAS_RECORDS",
    "SNAPPY_TPU_PALLAS_RESOLVE", "SNAPPY_TPU_PALLAS_ENCODE", "SNAPPY_TPU_FLAT_ENCODE",
    "SNAPPY_TPU_PALLAS_FASTPATH", "SNAPPY_TPU_PALLAS_COMPOSE", "SNAPPY_TPU_PURE_DEVICE",
    "SNAPPY_TPU_DEBUG",
)
VALUES.update({var: ("1", "0", "", "yes") for var in BOOLEAN})
CASES = [(var, v) for var in sorted(VALUES) for v in VALUES[var]]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """No ``SNAPPY_TPU_*`` variable from outside the test."""
    import os

    for var in [v for v in os.environ if v.startswith("SNAPPY_TPU_")]:
        monkeypatch.delenv(var)


def test_the_port_knows_every_variable_of_the_jax_package():
    assert set(C._ENV_KNOBS) | set(C._IGNORED_ENV) == set(jconfig._ENV_KNOBS) == set(VALUES)
    assert not set(C._ENV_KNOBS) & set(C._IGNORED_ENV)
    for var, (field, _) in C._ENV_KNOBS.items():
        assert jconfig._ENV_KNOBS[var][0] == field
    # The ignored ones set TPU-only fields, which the port does not have.
    assert not {jconfig._ENV_KNOBS[v][0] for v in C._IGNORED_ENV} & set(C._REFERENCE_FIELDS)


@pytest.mark.parametrize("var,value", CASES, ids=[f"{v[11:]}={x!r}" for v, x in CASES])
def test_env_variable_matches_the_jax_package(monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    want = C.config_from_reference(dataclasses.asdict(jconfig.get_config()))
    assert C.get_config() == want
    # Over a programmatic base too: the variable wins in both packages.
    with C.configure(decode_flat=False, threads=7, engine="native", debug=False):
        with jconfig.configure(pallas_flat=False, threads=7, engine="native", debug=False):
            want = C.config_from_reference(dataclasses.asdict(jconfig.get_config()))
            assert C.get_config() == want


# The seven cases of tests/test_config.py, as they apply to the port.


def test_defaults_match_documented_caps():
    cfg = C.Config()
    assert cfg.engine == "auto" and cfg.device == "cuda"
    assert cfg.decode_kernels is None and cfg.flat_encode is None
    assert cfg.decode_flat and not cfg.decode_records and not cfg.decode_resolve
    assert cfg.max_dpad == 1 << 20
    assert cfg.replay_max_body == 1 << 17
    assert cfg.decode_rows_per_launch == 512
    assert cfg.blocks_per_launch == 2048
    assert C.get_config() == cfg


def test_env_overrides_beat_programmatic(monkeypatch):
    with C.configure(decode_flat=False, threads=4):
        assert C.get_config().decode_flat is False
        assert C.get_config().threads == 4
        monkeypatch.setenv("SNAPPY_TPU_PALLAS_FLAT", "1")
        monkeypatch.setenv("SNAPPY_TPU_THREADS", "2")
        assert C.get_config().decode_flat is True
        assert C.get_config().threads == 2
    # context restored
    assert C.get_config().decode_flat is True  # env still set
    monkeypatch.delenv("SNAPPY_TPU_PALLAS_FLAT")
    monkeypatch.delenv("SNAPPY_TPU_THREADS")
    assert C.get_config() == C.Config()


def test_env_knob_semantics(monkeypatch):
    # On/off semantics: '' and '0' are off, anything else on.
    monkeypatch.setenv("SNAPPY_TPU_PALLAS_DECODE", "")
    assert C.get_config().decode_kernels is False
    monkeypatch.setenv("SNAPPY_TPU_PALLAS_DECODE", "1")
    assert C.get_config().decode_kernels is True
    # records and resolve are strict '1'
    monkeypatch.setenv("SNAPPY_TPU_PALLAS_RECORDS", "yes")
    assert C.get_config().decode_records is False
    monkeypatch.setenv("SNAPPY_TPU_PALLAS_RECORDS", "1")
    assert C.get_config().decode_records is True
    # a malformed threads value is ignored, not fatal
    monkeypatch.setenv("SNAPPY_TPU_THREADS", "not-a-number")
    assert C.get_config().threads == 0
    # the TPU-only variables change nothing
    monkeypatch.delenv("SNAPPY_TPU_PALLAS_DECODE")
    monkeypatch.delenv("SNAPPY_TPU_PALLAS_RECORDS")
    for var in C._IGNORED_ENV:
        monkeypatch.setenv(var, "compose")
    assert C.get_config() == C.Config()


def test_configure_rejects_unknown_fields():
    with pytest.raises(TypeError):
        with C.configure(nonsense=True):
            pass


def test_set_config_full_object_and_overrides(monkeypatch):
    saved = C.set_config(C.Config())
    try:
        C.set_config(decode_rows_per_launch=128)
        assert C.get_config().decode_rows_per_launch == 128
        monkeypatch.setenv("SNAPPY_TPU_DEBUG", "1")
        assert C.get_config().debug and C.get_config().decode_rows_per_launch == 128
        with pytest.raises(TypeError):
            C.set_config(C.Config(), threads=1)
    finally:
        C.set_config(saved)


def test_engine_knob_via_config(monkeypatch):
    with C.configure(engine="reference"):
        assert engine.get_engine("auto").name == "reference"
        # explicit argument still wins over the config default
        assert engine.get_engine("native").name == "native"
    monkeypatch.setenv("SNAPPY_TPU_ENGINE", "reference")
    with C.configure(engine="native"):
        assert engine.get_engine("auto").name == "reference"  # the variable wins


def test_decode_routing_respects_config(monkeypatch):
    # decode_kernels with decode_flat off pins the replay kernel (its plain
    # version on the CPU), from the configuration or from the variables.
    data = (b"the quick brown fox " * 40)[:700]
    body = ref.compress(data)[len(write_varu64(len(data))):]
    routes = []
    monkeypatch.setattr("snappy_tpu_torch.ops.api.routes", routes)
    with C.configure(device="cpu", decode_kernels=True, decode_flat=False):
        outs, errs, _ = decompress_streams([body], [len(data)])
    assert outs[0] == data and int(errs[0]) == 0
    monkeypatch.setenv("SNAPPY_TPU_PALLAS_DECODE", "1")
    monkeypatch.setenv("SNAPPY_TPU_PALLAS_FLAT", "0")
    with C.configure(device="cpu"):
        outs, errs, _ = decompress_streams([body], [len(data)])
    assert outs[0] == data and int(errs[0]) == 0
    assert [r[2] for r in routes] == ["replay", "replay"]


@pytest.mark.parametrize("name", ["reference", "native", "device", "device-fast"])
def test_auto_engine_under_the_variable_matches_the_jax_package(monkeypatch, name):
    """``SNAPPY_TPU_ENGINE`` picks the engine of ``"auto"``, which the
    adapters and ``szip`` take, in both packages alike."""
    monkeypatch.setenv("SNAPPY_TPU_ENGINE", name)
    assert engine.get_engine("auto").name == jengine.get_engine("auto").name == name
    assert engine.get_engine("").name == name
