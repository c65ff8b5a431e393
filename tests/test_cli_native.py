"""CLI harness + native tool tests: generator parity (Python vs C++ vs the
format reader), benchmark CSV flow."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_GEN = os.path.join(REPO, "native", "matrix_generator")


def _build_native():
    if os.path.exists(NATIVE_GEN):
        return True
    if shutil.which("make") is None or shutil.which("g++") is None:
        return False
    r = subprocess.run(["make", "-C", os.path.join(REPO, "native")], capture_output=True)
    return r.returncode == 0 and os.path.exists(NATIVE_GEN)


def test_python_generator_cli(tmp_path):
    out = str(tmp_path / "corpus.txt")
    r = subprocess.run(
        [sys.executable, "-m", "mpf_tpu.cli.matrix_generator", out, "8"],
        capture_output=True, text=True, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    from mpf_tpu.utils import matio

    mats = matio.read_matrix_file(out)
    assert [m.shape[0] for m in mats] == [2, 4, 8]


def test_generator_matches_library(tmp_path):
    """CLI output parses back to exactly the library-generated corpus."""
    out = str(tmp_path / "corpus.txt")
    subprocess.run(
        [sys.executable, "-m", "mpf_tpu.cli.matrix_generator", out, "8", "2", "exp", "0.2"],
        capture_output=True, cwd=REPO, check=True,
    )
    from mpf_tpu.utils import matio, matgen

    got = matio.read_matrix_file(out)
    want = matgen.generate_corpus(8, 2, "exp", 0.2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.skipif(not _build_native(), reason="native toolchain unavailable")
def test_native_generator_bit_parity(tmp_path):
    """C++ (libc rand) and Python (glibc clone) generators emit identical
    bytes — the reference's reproducible-corpus property (SURVEY.md #9)."""
    c_out = str(tmp_path / "c.txt")
    py_out = str(tmp_path / "py.txt")
    subprocess.run([NATIVE_GEN, c_out, "16", "2", "exp", "0.3"], capture_output=True, check=True)
    subprocess.run(
        [sys.executable, "-m", "mpf_tpu.cli.matrix_generator", py_out, "16", "2", "exp", "0.3"],
        capture_output=True, cwd=REPO, check=True,
    )
    assert open(c_out, "rb").read() == open(py_out, "rb").read()


@pytest.mark.skipif(not _build_native(), reason="native toolchain unavailable")
def test_native_matio_reader(tmp_path):
    from mpf_tpu.utils import matio, matgen

    lib = matio._native_lib()
    if lib is None:
        pytest.skip("libmatio.so not loadable")
    path = str(tmp_path / "c.txt")
    mats = matgen.generate_corpus(8)
    matio.write_matrix_file(path, mats)
    back = matio.read_matrix_file(path)  # uses native parser when available
    for a, b in zip(mats, back):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_benchmark_cli(tmp_path):
    corpus = str(tmp_path / "corpus.txt")
    from mpf_tpu.utils import matio, matgen

    matio.write_matrix_file(corpus, matgen.generate_corpus(8))
    csv = str(tmp_path / "times.csv")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "mpf_tpu.cli.benchmark", corpus, "--csv", csv, "--r", "4"],
        capture_output=True, text=True, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr
    lines = open(csv).read().strip().splitlines()
    assert lines[0].startswith("matrix_size,")
    assert len(lines) == 4  # header + 3 matrices
    assert "incorrect" not in r.stdout


def test_benchmark_cli_dist(tmp_path):
    """--dist PxQ runs the block-cyclic distributed driver (VERDICT round-2
    item 8) on a virtual CPU mesh."""
    corpus = str(tmp_path / "corpus.txt")
    from mpf_tpu.utils import matio, matgen

    matio.write_matrix_file(corpus, [matgen.hpl_ai_matrix(64, seed=2)])
    csv = str(tmp_path / "times.csv")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8",
    )
    r = subprocess.run(
        [sys.executable, "-m", "mpf_tpu.cli.benchmark", corpus, "--csv", csv,
         "--r", "8", "--dist", "2x4"],
        capture_output=True, text=True, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr
    lines = open(csv).read().strip().splitlines()
    assert len(lines) == 2 and lines[1].startswith("64,")
    assert "incorrect" not in r.stdout


def test_probe_cli():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "mpf_tpu.cli.probe", "--json"],
        capture_output=True, text=True, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr
    import json

    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["num_devices"] >= 1
