"""chip_smoke.py rehearsed on the CPU: every phase at a tiny size (the
kernels through the jnp pivot panel the CPU selects and the Triton
interpreter), and main() refusing to run without a GPU."""

import json

import pytest

import chip_smoke as cs


def test_kernels_phase():
    out = cs.phase_kernels(m=256, r=16)
    assert all(v for k, v in out.items() if k.startswith("k1_"))
    assert out["k2_hpl_rel"] <= cs.K2_TOL and out["k2_uniform_rel"] <= cs.K2_TOL
    assert out["k2_zero_info"] == 16 // 3 + 1


def test_oracle_phase():
    out = cs.phase_oracle(n=128, r=16)
    assert max(out.values()) <= cs.NBE_TOL


def test_ir_phase():
    assert cs.phase_ir(n=256, r=32)["be"] <= cs.IR_TOL


def test_factor_phase():
    out = cs.phase_factor(n=256, r=32, runs=2)
    assert out["hpl"] > 0 and out["uniform"] > 0 and out["compile_s"] > 0


def test_solve_phase():
    assert cs.phase_solve(n=256, r=32)["be"] <= cs.IR_TOL


def test_equilibrate_phase():
    assert cs.phase_equilibrate(n=64)["be"] <= cs.IR_TOL


def test_batched_phase():
    out = cs.phase_batched(batch=4, n=32, r=8)
    assert len(out["nbe"]) == 3


def test_dist_phase_on_virtual_devices():
    out = cs.phase_dist(n=512, b=32, n_small=256)
    assert len(set(out["placed"])) == 4
    assert out["ir_be"] <= cs.IR_TOL
    assert out["share_fp32_hpl"] == out["share_fp32_uniform"] == 1.0


def test_check_raises():
    with pytest.raises(RuntimeError, match="check failed: x"):
        cs.check(False, "x")


@pytest.mark.parametrize("argv", [[], ["--chips", "4"]])
def test_main_refuses_cpu(argv, capsys):
    assert cs.main(argv) != 0
    captured = capsys.readouterr()
    assert "needs a CUDA GPU" in captured.err
    assert all(not line.startswith("{") for line in captured.out.splitlines())
    with pytest.raises(json.JSONDecodeError):
        json.loads(captured.out.strip().splitlines()[-1] if captured.out.strip() else "")
