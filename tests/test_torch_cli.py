"""The port's ``szip`` (``snappy_tpu_torch.cli.szip``) against the JAX
package's (``snappy_tpu.cli.szip``), byte for byte: the same scenario runs
in two directories, one per CLI, and every step's exit code, stderr and
files (names, bytes, and whether they carry their source's times) must
agree: compress and decompress with and
without ``-k`` and ``-f``, ``--raw``, ``--resume`` after a cut, stdin to
stdout, and the messages of skipped files and corrupt inputs. The port
runs with the host engines and with ``device`` and ``device-fast`` on the
CPU (``configure(device="cpu")``, the kernels' plain versions). The JAX
package runs under ``flat_encode=True``: the port's default (``None``)
takes the flat encoder for ``device-fast``, as the JAX package's does only
on a TPU."""

import io
import os
import random
import subprocess
import sys
import types

import pytest

import snappy_tpu
from conftest import load_corpus
from snappy_tpu.cli import szip as jax_szip
from snappy_tpu_torch.cli import szip
from snappy_tpu_torch.config import configure
from torch_vectors import REPO, hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

ENGINES = ["auto", "native", "reference", "device", "device-fast"]
TEXT = load_corpus("alice29.txt")[:30000]
# Past 64 KiB, so that the device engine's frame writer takes the card's
# path; a short pattern keeps the CPU's plain encoder quick.
LONG = (b"resumable frame stream, " * 6000)[:140000]


STAMP = (1_000_000, 2_000_000)


def _put(path, data):
    path.write_bytes(data)
    os.utime(path, STAMP)


def _snapshot(d):
    """Each entry's name, bytes, and whether it carries its source's
    times (a file the CLI made, or one the scenario wrote)."""
    return sorted(
        (p.name, p.read_bytes() if p.is_file() else None, int(p.stat().st_mtime) == STAMP[1])
        for p in d.iterdir()
    )


def _scenario(name, run, d):
    """Run scenario ``name`` through ``run(args)`` in directory ``d``;
    returns every step's ``(exit code, stderr, files)``."""
    steps = []

    def step(*args):
        steps.append((*run(list(args)), _snapshot(d)))

    if name == "files":
        _put(d / "f.txt", TEXT)
        step("-k", "f.txt")
        step("f.txt")  # the output exists
        step("-f", "f.txt")
        step("-d", "f.txt.sz")
    elif name == "raw":
        _put(d / "r.bin", TEXT)
        step("-r", "-k", "r.bin")
        (d / "r.bin").unlink()
        step("-r", "-d", "r.bin.sz")
    elif name == "skips":
        for f, data in (("x.sz", b"zz"), ("y.bin", b"zz"), ("good.bin", b"fine content here")):
            _put(d / f, data)
        (d / "subdir").mkdir()
        step("x.sz")
        step("-d", "-k", "y.bin")
        step("missing.bin", "good.bin", "subdir")
    elif name == "resume":
        _put(d / "f.txt", LONG)
        step("-k", "f.txt")
        sz = d / "f.txt.sz"
        with open(sz, "r+b") as f:
            f.truncate(sz.stat().st_size * 2 // 3 + 7)
        step("-k", "--resume", "f.txt")
        (d / "f.txt").unlink()
        step("-d", "f.txt.sz")
        assert (d / "f.txt").read_bytes() == LONG
    elif name == "corrupt":
        # A flipped byte in a frame stream; a raw stream cut in half.
        for flags, spoil in (([], lambda b: b[:len(b) // 2] + bytes([b[len(b) // 2] ^ 0x5A])
                              + b[len(b) // 2 + 1:]), (["-r"], lambda b: b[: len(b) // 2])):
            _put(d / "c.txt", TEXT)
            step(*flags, "-f", "c.txt")
            _put(d / "c.txt.sz", spoil((d / "c.txt.sz").read_bytes()))
            step(*flags, "-k", "c.txt.sz")
    return steps


@pytest.mark.parametrize("scenario", ["files", "raw", "skips", "resume", "corrupt"])
@pytest.mark.parametrize("engine", ENGINES)
def test_cli_matches_jax_package(engine, scenario, tmp_path, monkeypatch, capsys):
    transcripts = []
    for name, main in (("port", szip.main), ("jax", jax_szip.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)

        def run(args, main=main):
            with configure(device="cpu"), snappy_tpu.configure(flat_encode=True):
                rc = main(["--engine", engine, *args])
            return rc, capsys.readouterr().err

        transcripts.append(_scenario(scenario, run, d))
    assert transcripts[0] == transcripts[1]
    if scenario == "corrupt":
        assert all(transcripts[0][k][1].startswith("c.txt.sz: ") for k in (1, 3))


def _pipe(main, args, data):
    out = io.BytesIO()
    monkey = (sys.stdin, sys.stdout)
    sys.stdin = types.SimpleNamespace(buffer=io.BytesIO(data))
    sys.stdout = types.SimpleNamespace(buffer=out)
    try:
        with configure(device="cpu"), snappy_tpu.configure(flat_encode=True):
            assert main(args) == 0
    finally:
        sys.stdin, sys.stdout = monkey
    return out.getvalue()


@pytest.mark.parametrize("engine", ENGINES)
def test_stdin_to_stdout_matches_jax_package(engine):
    for args, data in ((["--engine", engine], LONG), (["--engine", engine, "-r"], TEXT)):
        comp = _pipe(szip.main, args, data)
        assert comp == _pipe(jax_szip.main, args, data)
        assert _pipe(szip.main, [*args, "-d"], comp) == data


def test_module_entry_point_round_trips():
    data = random.Random(9).randbytes(100_000) + b"abc" * 30_000
    cmd = [sys.executable, "-m", "snappy_tpu_torch.cli.szip", "--engine", "native"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    comp = subprocess.run(cmd, input=data, capture_output=True, cwd=REPO, env=env,
                          check=True).stdout
    assert comp == _pipe(jax_szip.main, ["--engine", "native"], data)
    out = subprocess.run([*cmd, "-d"], input=comp, capture_output=True, cwd=REPO, env=env,
                         check=True).stdout
    assert out == data
