"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, and its entry points never run quietly on the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from torch_vectors import hold_jax_native

hold_jax_native()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "snappy_tpu_torch",
    "snappy_tpu_torch.bench",
    "snappy_tpu_torch.cli",
    "snappy_tpu_torch.cli.szip",
    "snappy_tpu_torch.config",
    "snappy_tpu_torch.engine",
    "snappy_tpu_torch.examples",
    "snappy_tpu_torch.examples.compress",
    "snappy_tpu_torch.examples.compress_escaped",
    "snappy_tpu_torch.examples.decompress",
    "snappy_tpu_torch.examples.gpu_pipeline",
    "snappy_tpu_torch.error",
    "snappy_tpu_torch.format.reference",
    "snappy_tpu_torch.frame",
    "snappy_tpu_torch.graft_entry",
    "snappy_tpu_torch.native",
    "snappy_tpu_torch.ops._build",
    "snappy_tpu_torch.ops.api",
    "snappy_tpu_torch.ops.crc32c",
    "snappy_tpu_torch.ops.decode",
    "snappy_tpu_torch.ops.decode_flat",
    "snappy_tpu_torch.ops.emit",
    "snappy_tpu_torch.ops.encode",
    "snappy_tpu_torch.ops.encode_fast",
    "snappy_tpu_torch.ops.encode_flat",
    "snappy_tpu_torch.ops.frame",
    "snappy_tpu_torch.ops.packing",
    "snappy_tpu_torch.ops.parse",
    "snappy_tpu_torch.ops.records",
    "snappy_tpu_torch.ops.replay",
    "snappy_tpu_torch.ops.resolve",
    "snappy_tpu_torch.parallel",
    "snappy_tpu_torch.parallel.mesh",
    "snappy_tpu_torch.parallel.multihost",
    "snappy_tpu_torch.parallel.sharded",
    "snappy_tpu_torch.raw",
    "snappy_tpu_torch.read",
    "snappy_tpu_torch.tools",
    "snappy_tpu_torch.tools.crossover_measure",
    "snappy_tpu_torch.tools.flatten_scale",
    "snappy_tpu_torch.tools.fuzz_campaign",
    "snappy_tpu_torch.tools.scaling_measure",
    "snappy_tpu_torch.trace",
    "snappy_tpu_torch.utils",
    "snappy_tpu_torch.utils.cpp_oracle",
    "snappy_tpu_torch.utils.profiling",
    "snappy_tpu_torch.write",
]


def _foreign(name: str) -> bool:
    return name.startswith("jax") or name == "snappy_tpu" or name.startswith("snappy_tpu.")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        check=True, capture_output=True, text=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert set(PORT_MODULES) <= set(loaded)
    assert [m for m in loaded if _foreign(m)] == []


def _imported(path: str, module: str) -> set[str]:
    """Every module that the file at ``path`` (the module ``module``) imports,
    at any depth of its code, relative imports resolved: for ``from X import
    n`` both ``X`` and ``X.n``."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    package = module if path.endswith("__init__.py") else module.rpartition(".")[0]
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package.rsplit(".", node.level - 1)[0] if node.level else ""
            base = ".".join(p for p in (base, node.module) if p)
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


def test_the_recorder_sits_below_every_stage():
    """``trace.py`` imports nothing of the port, so that every stage can
    import it; and no stage below the API (``ops/`` but ``api.py`` and the
    package's own ``__init__.py``, which exports it) and no module of
    ``parallel/`` imports ``ops.api``."""
    root = os.path.join(REPO, "snappy_tpu_torch")
    mine = _imported(os.path.join(root, "trace.py"), "snappy_tpu_torch.trace")
    assert mine and not any(m.split(".")[0] == "snappy_tpu_torch" for m in mine)
    below = []
    for sub in ("ops", "parallel"):
        for name in sorted(os.listdir(os.path.join(root, sub))):
            if name.endswith(".py") and not (sub == "ops" and name in ("api.py", "__init__.py")):
                module = f"snappy_tpu_torch.{sub}.{name[:-3]}".removesuffix(".__init__")
                below.append((module, _imported(os.path.join(root, sub, name), module)))
    assert len(below) > 15
    assert any("snappy_tpu_torch.trace" in got for _, got in below)
    assert [m for m, got in below if "snappy_tpu_torch.ops.api" in got] == []


@pytest.mark.parametrize("script", ["chip_smoke.py", "flat_gather_probe.py", "encode_records_probe.py",
                                    "resolve_parse_probe.py", "crc_emit_probe.py",
                                    "replay_resolve_probe.py", "emit_bytes_probe.py",
                                    "multi_card_probe.py"])
def test_card_scripts_import_no_jax_and_nothing_of_the_jax_package(script):
    """The scripts that run on the card (where there is no JAX) import
    neither JAX nor the JAX package, at any depth of their code: besides the
    standard library, numpy and torch, only the port (whose import graph the
    test above walks) and ``chip_smoke`` (a case of this test), and no test
    helper."""
    import ast

    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    modules = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    modules += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    tops = {m.split(".")[0] for m in modules}
    assert "snappy_tpu_torch" in tops
    assert [m for m in modules if _foreign(m)] == []
    assert tops - set(sys.stdlib_module_names) <= {"numpy", "torch", "snappy_tpu_torch", "chip_smoke"}


@pytest.mark.parametrize("entry", ["decompress", "decompress_frame", "compress"])
def test_default_device_without_a_card_raises(entry, monkeypatch):
    import snappy_tpu_torch
    from snappy_tpu_torch.format import reference as ref

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert snappy_tpu_torch.get_config().device == "cuda"
    text = b"hello hello hello hello"
    arg, want = {
        "decompress": (ref.compress(text), text),
        "decompress_frame": (b"\xff\x06\x00\x00sNaPpY", b""),
        "compress": (text, None),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(snappy_tpu_torch, entry)(arg)
    # The explicit CPU request runs the kernels' plain versions.
    got = getattr(snappy_tpu_torch, entry)(arg, device="cpu")
    assert got == want if want is not None else ref.decompress(got) == text


BIG = b"0123456789abcdef" * 5000  # over 64 KiB: the device frame writer


@pytest.mark.parametrize("adapter", ["frame-writer", "frame-reader", "raw-decoder", "raw-encoder-fast"])
def test_device_engines_without_a_card_raise(adapter, monkeypatch):
    """The ``device`` engines run on ``Config.device``, ``cuda`` by default:
    without a card they raise; under ``configure(device="cpu")`` they run
    the kernels' plain versions."""
    import io

    import snappy_tpu_torch
    from snappy_tpu_torch import native, raw, read, write

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = native.frame_compress(BIG)

    def run():
        if adapter == "frame-writer":
            out = io.BytesIO()
            write.FrameEncoder(out, engine="device").write(BIG)
            return native.frame_decompress(out.getvalue())
        if adapter == "frame-reader":
            return read.FrameDecoder(io.BytesIO(stream), engine="device").read()
        if adapter == "raw-decoder":
            return raw.Decoder("device").decompress_vec(native.compress(BIG))
        return native.decompress(raw.Encoder("device-fast").compress_vec(BIG))

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with snappy_tpu_torch.configure(device="cpu"):
        assert run() == BIG


def test_configured_cpu_device_is_honoured(monkeypatch):
    import snappy_tpu_torch
    from snappy_tpu_torch.format import reference as ref

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = ref.compress(b"abcabcabcabcabc")
    with snappy_tpu_torch.configure(device="cpu"):
        assert snappy_tpu_torch.decompress(raw) == b"abcabcabcabcabc"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snappy_tpu_torch.decompress(raw)


def test_cuda_tensor_without_a_card_does_not_fall_back():
    """A wrapper chooses its plain version only for CPU tensors; anything
    else is refused rather than decoded on the CPU."""
    from snappy_tpu_torch.ops import crc32c

    rows = torch.zeros((1, 16), dtype=torch.uint8, device="meta")
    lens = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        crc32c.crc32c_masked_blocks(rows, lens)


@pytest.mark.parametrize(
    "kernel", ["resolve_fh", "resolve", "decode_records", "decode_flat_grouped"]
)
def test_new_kernel_wrappers_do_not_fall_back(kernel):
    """K8, K9, K10 and K11 take their plain versions only for CPU tensors: a
    tensor on another device is refused, not decoded on the CPU."""
    from snappy_tpu_torch.ops import decode_flat, records, resolve

    def t(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    call = {
        "resolve_fh": lambda: resolve.resolve_fh(t((1, 512)), t((1, 512)), t(1), 1024),
        "resolve": lambda: resolve.resolve(t((1, 1024))),
        "decode_records": lambda: records.decode_records(
            t((1, 128), torch.uint8), t((1, 512, 2)), t(1), t(1), 1024),
        "decode_flat_grouped": lambda: decode_flat.decode_flat_grouped(
            t((1, 128), torch.uint8), t((1, 16384), torch.int16), t((1, 16, 2)), t((1, 1)),
            t(1), 16384, 4),
    }[kernel]
    with pytest.raises(ValueError, match="unsupported device"):
        call()


@pytest.mark.parametrize("route", ["decode_records", "decode_resolve"])
def test_record_scan_routes_without_a_card_raise(route, monkeypatch):
    import snappy_tpu_torch
    from snappy_tpu_torch import native

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = native.frame_compress(BIG)
    with snappy_tpu_torch.configure(**{route: True}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            snappy_tpu_torch.decompress_frame(stream)
        assert snappy_tpu_torch.decompress_frame(stream, device="cpu") == BIG


@pytest.mark.parametrize("route", [
    {"decode_kernels": False}, {"pure_device": True}, {"decode_flat": False},
], ids=["parallel_hosted", "parallel", "replay"])
def test_tensor_and_replay_routes_without_a_card_raise(route, monkeypatch):
    """The tensor routes run on ``Config.device`` too: without a card they
    raise, and on ``device="cpu"`` they decode."""
    import snappy_tpu_torch
    from snappy_tpu_torch import native

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = native.frame_compress(BIG)
    with snappy_tpu_torch.configure(**route):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            snappy_tpu_torch.decompress_frame(stream)
        assert snappy_tpu_torch.decompress_frame(stream, device="cpu") == BIG


def test_public_surface():
    import snappy_tpu_torch

    assert set(snappy_tpu_torch.__all__) == {
        "compress", "decompress", "decompress_frame", "engine", "error", "SnappyError", "raw",
        "read", "write", "Config", "configure", "get_config", "set_config", "__version__",
    }
    assert all(hasattr(snappy_tpu_torch, n) for n in snappy_tpu_torch.__all__)
    assert snappy_tpu_torch.Config().device == "cuda"


def test_surface_agrees_with_the_jax_package():
    """The JAX package's ``__all__`` and the names it loads on first access
    are the port's too (the port adds its three entry points and
    ``engine``); each lazy name gives the port's module of that name, loaded
    in a fresh process only when it is first touched."""
    import snappy_tpu
    import snappy_tpu_torch

    assert set(snappy_tpu_torch.__all__) == set(snappy_tpu.__all__) | {
        "compress", "decompress", "decompress_frame", "engine"}
    assert snappy_tpu_torch.__version__ == snappy_tpu.__version__
    lazy = ("raw", "read", "write", "frame", "format", "ops", "parallel")
    for name in lazy:
        assert getattr(snappy_tpu, name).__name__ == f"snappy_tpu.{name}"
        assert getattr(snappy_tpu_torch, name).__name__ == f"snappy_tpu_torch.{name}"
    with pytest.raises(AttributeError):
        snappy_tpu_torch.no_such_module  # noqa: B018
    code = (
        "import sys, snappy_tpu_torch as st\n"
        "assert 'snappy_tpu_torch.parallel' not in sys.modules\n"
        "st.set_config(threads=2); assert st.get_config().threads == 2\n"
        "print(st.parallel.make_mesh(['cpu']).size)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         check=True, capture_output=True, text=True).stdout
    assert out.strip() == "1"


JAX_OPS_NAMES = {  # snappy_tpu/ops/__init__.py's imports
    "api": "api", "packing": "packing", "decode_batch": "decode", "decode_batch_hosted": "decode",
    "compress_blocks": "encode", "compress_blocks_fast": "encode_fast",
    "crc32c_blocks": "crc32c", "crc32c_masked_blocks": "crc32c", "encode_frame_chunks": "frame",
}


@pytest.mark.parametrize("name", sorted(JAX_OPS_NAMES))
def test_ops_exports_the_jax_packages_names(name):
    """``snappy_tpu_torch.ops`` exports each name ``snappy_tpu.ops`` does, as
    the port's function (or module) of that name."""
    import importlib
    import types

    import snappy_tpu.ops as jops
    import snappy_tpu_torch.ops as ops

    mine, theirs = getattr(ops, name), getattr(jops, name)
    module = importlib.import_module(f"snappy_tpu_torch.ops.{JAX_OPS_NAMES[name]}")
    if isinstance(theirs, types.ModuleType):
        assert mine is module and theirs.__name__ == f"snappy_tpu.ops.{name}"
    else:
        assert mine is getattr(module, name) and mine.__module__ == module.__name__


def test_parallel_exports_the_jax_packages_names(monkeypatch):
    """``snappy_tpu_torch.parallel`` exports what ``snappy_tpu.parallel``
    does: ``ParallelConfig`` with the same frozen fields and defaults, and
    ``auto_mesh()`` as ``make_mesh()``."""
    import dataclasses

    import snappy_tpu.parallel as jpar
    import snappy_tpu_torch.parallel as par

    names = ("ParallelConfig", "auto_mesh", "make_mesh", "sharded_compress_blocks",
             "sharded_decode_streams", "sharded_encode_frame_chunks")
    assert all(hasattr(jpar, n) and getattr(par, n).__module__.startswith("snappy_tpu_torch.")
               for n in names)
    fields = [(f.name, f.default) for f in dataclasses.fields(par.ParallelConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(jpar.ParallelConfig)]
    assert par.ParallelConfig() == par.ParallelConfig(64, 1 << 18)
    with pytest.raises(dataclasses.FrozenInstanceError):
        par.ParallelConfig().blocks_per_device = 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.auto_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert par.auto_mesh() == par.make_mesh()
    assert par.auto_mesh().devices == tuple(torch.device("cuda", i) for i in range(3))
