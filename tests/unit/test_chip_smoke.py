"""chip_smoke.py, bench.py and benchmarks/roofline.py at tiny sizes on
the CPU: their phase functions run and check, and their entry points
refuse a machine without a GPU (they never fall back)."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("argv", ([], ["--four"]))
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_phase_fft_tiny():
    recs = chip_smoke.phase_fft(sizes=(64, 256), rows=32, oracle_rows=8)
    assert {(r["kind"], r["n"]) for r in recs} == {
        (k, n) for k in ("fft", "ifft", "rfft", "irfft") for n in (64, 256)}
    assert min(r["snr_db"] for r in recs) >= chip_smoke.FFT_MIN_DB


def test_phase_chain_tiny(tmp_path):
    rec = chip_smoke.phase_chain(str(tmp_path), seed=1, channels=4,
                                 seconds=1.5, oracle_channels=2)
    assert rec["snr_full_vs_oracle"] >= chip_smoke.ORACLE_MIN_DB
    assert rec["snr_stream_vs_full"] >= chip_smoke.STREAM_MIN_DB


def test_oracle_config5_matches_driver_chain():
    """The oracle phase 3 and --four compare against is the chain the
    config-5 driver builds (same taps, envelope and gate)."""
    import jax

    from tools import run_config_5

    rng = np.random.default_rng(0)
    x = 0.01 * rng.standard_normal((1, 147 * 200))
    x[:, 8000:20000] += np.sin(np.arange(12000) * 0.06)
    chain = run_config_5.build_chain()
    chain.build()
    y = np.asarray(jax.jit(chain.full)(x))
    ref = chip_smoke.oracle_config5(x)
    m = ref.shape[-1]
    assert chip_smoke._snr(ref, y[:, :m]) >= 100.0


def test_phase_configs_tiny():
    recs = chip_smoke.phase_configs({1: 0.5, 2: 0.5, 3: 0.5, 4: 0.3})
    assert [r["config"][:7] for r in recs] == [
        "config1", "config2", "config3", "config4"]
    assert all(r["device"]["platform"] == "cpu" for r in recs)


def test_phase_four_tiny(tmp_path):
    """The --four phase on this host's 8 virtual devices: sharded configs
    3/4/5 vs one device and the oracle."""
    recs = chip_smoke.phase_four(str(tmp_path), seconds3=0.5, seconds4=0.3,
                                 seconds5=1.0, oracle_channels=2)
    assert [r["config"] for r in recs] == ["config3", "config4",
                                           "config5_sharded"]
    assert all(r["devices"] == 8 for r in recs)


def test_bench_refuses_cpu():
    import bench

    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code not in (0, None)
    with pytest.raises(ValueError, match="unknown bench mode"):
        bench.main(["res_chain"])


@pytest.mark.parametrize("mode", ("chain", "stream"))
def test_bench_modes_run(mode):
    import bench

    assert bench.bench(mode, channels=2, seconds=0.1, iters=1) > 0


@pytest.mark.parametrize("kind", ("fft", "ifft", "rfft", "irfft"))
def test_roofline_fft_row(kind):
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import roofline

    x = roofline.fft_input(kind, 8, 64)
    assert x.shape == (8, 33 if kind == "irfft" else 64)
    dt, gbps = roofline.bench_fft("xla", kind, 8, 64, iters=1)
    assert dt > 0 and gbps == roofline.fft_bytes(kind, 8, 64) / dt / 1e9


def test_phase_config5_driver_tiny():
    """tools/run_config_5.py stream and ring modes at full width (128
    channels), 0.5 s, through their own --check paths."""
    recs = chip_smoke.phase_config5_driver(seed=1, seconds=0.5)
    assert [r["config"] for r in recs] == [
        "config5_streaming_128ch_stream", "config5_streaming_128ch_ring"]


def test_config5_bench_tiny():
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import config5

    with pytest.raises(SystemExit):
        config5.main([])
    rec = config5.measure(seconds=0.5, iters=1, channels=2)
    assert rec["samples"] == 2 * config5.BLOCK and rec["step_s"] > 0


def test_config5_trace_reduction_cpu(tmp_path):
    """The trace reduction reads a real trace; a CPU trace has no GPU
    plane, so it reports nothing rather than host time."""
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import glob

    import jax
    import jax.numpy as jnp

    import config5

    f = jax.jit(lambda v: jnp.fft.rfft(v) * 2)
    x = jnp.ones((8, 256))
    jax.block_until_ready(f(x))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(f(x))
    path = glob.glob(str(tmp_path / "plugins/profile/*/*.xplane.pb"))[0]
    assert config5.device_op_times(path) == {"busy_share": None,
                                             "top_ops": []}
