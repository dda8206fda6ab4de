"""utils subsystem tests: metrics, debug, profiling (SURVEY.md §5)."""

import io

import numpy as np
import pytest

from audiosignalprocess_tpu.utils import debug, metrics
from audiosignalprocess_tpu.utils.profiling import BlockLogger, annotate, named_scope


class TestMetrics:
    def test_snr_db(self):
        x = np.ones(100)
        assert metrics.snr_db(x, x) == np.inf
        noisy = x + 1e-3
        assert 55 < metrics.snr_db(x, noisy) < 65

    def test_roofline_model(self):
        spec = metrics.device_spec("NVIDIA H100 80GB HBM3")
        b = metrics.fft_roofline_bytes(64, 1024, 4, complex_io=True)
        assert b == 2 * 64 * 1024 * 8
        assert metrics.roofline_time_s(b, spec) == b / (spec.hbm_gbps * 1e9)

    def test_detect_chip(self):
        """The peak table is keyed by device_kind; a device it does not
        hold (this CPU) is an error, never a default."""
        import jax

        with pytest.raises(KeyError, match="no published peaks"):
            metrics.device_spec()
        with pytest.raises(KeyError, match=jax.devices()[0].device_kind):
            metrics.device_spec(jax.devices()[0].device_kind)

    @pytest.mark.parametrize("kind,hbm,f32,tf32,bf16", (
        ("NVIDIA H100 80GB HBM3", 3350.0, 67.0, 495.0, 989.0),
        ("NVIDIA H100 PCIe", 2000.0, 51.0, 378.0, 756.0),
    ))
    def test_peak_table(self, kind, hbm, f32, tf32, bf16):
        spec = metrics.device_spec(kind)
        assert (spec.hbm_gbps, spec.f32_tflops, spec.tf32_tflops,
                spec.bf16_tflops) == (hbm, f32, tf32, bf16)
        assert "data sheet" in spec.source

    @pytest.mark.parametrize("kind", ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 NVL",
                                      "cpu", ""))
    def test_unknown_device_raises(self, kind):
        with pytest.raises(KeyError):
            metrics.device_spec(kind)


class TestDebug:
    def test_assert_snr(self):
        x = np.random.default_rng(0).standard_normal(256)
        assert debug.assert_snr(x, x + 1e-9) > 60
        with pytest.raises(AssertionError):
            debug.assert_snr(x, x + 0.5, min_db=60)

    def test_nan_checks_scope(self):
        import jax

        with debug.nan_checks():
            assert jax.config.jax_debug_nans
        assert not jax.config.jax_debug_nans


class TestProfiling:
    def test_block_logger(self):
        buf = io.StringIO()
        bl = BlockLogger(stream=buf, every=1)
        for _ in range(3):
            bl.tick(1024, stage="fir")
        lines = [l for l in buf.getvalue().splitlines() if l]
        assert len(lines) == 2  # first tick only sets the clock
        import json

        rec = json.loads(lines[0])
        assert rec["samples"] == 1024 and rec["stage"] == "fir"

    def test_named_scope_and_annotate(self):
        import jax.numpy as jnp

        with named_scope("test"), annotate("test"):
            assert float(jnp.sum(jnp.ones(4))) == 4.0


def test_conformance_doc_fresh():
    """docs/CONFORMANCE.md is regenerated from the oracle docstrings;
    a stale doc means a convention changed without the doc."""
    import subprocess, sys, pathlib

    repo = pathlib.Path(__file__).resolve().parents[2]
    r = subprocess.run(
        [sys.executable, str(repo / "tools" / "gen_conformance.py"),
         "--check"], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_api_doc_fresh():
    """docs/API.md is regenerated from the public docstrings; a stale
    doc means the API changed without the reference page."""
    import os, subprocess, sys, pathlib

    repo = pathlib.Path(__file__).resolve().parents[2]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, str(repo / "tools" / "gen_api.py"), "--check"],
        capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stdout + r.stderr


class TestCompileCache:
    """utils.compile_cache: JAX_COMPILATION_CACHE_DIR wins untouched;
    otherwise one fixed directory inside the checkout."""

    def _calls(self, monkeypatch):
        import jax

        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: calls.append((k, v)))
        return calls

    def test_env_set_is_honoured(self, monkeypatch, tmp_path):
        from audiosignalprocess_tpu.utils import compile_cache

        calls = self._calls(monkeypatch)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.setup_compile_cache() == str(tmp_path)
        assert calls == []

    def test_env_unset_uses_fixed_checkout_path(self, monkeypatch):
        import pathlib

        from audiosignalprocess_tpu.utils import compile_cache

        calls = self._calls(monkeypatch)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = pathlib.Path(__file__).resolve().parents[2]
        want = str(repo / ".jax_cache")
        assert compile_cache.setup_compile_cache() == want
        assert compile_cache.setup_compile_cache() == want  # stable
        assert calls == [("jax_compilation_cache_dir", want)] * 2
        ignored = (repo / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored


class TestLaunch:
    """parallel.launch.initialize: jax.distributed starts only from an
    explicit coordinator; no cluster detection, no silent fallback."""

    def _calls(self, monkeypatch):
        import jax

        calls = []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: calls.append(kw))
        return calls

    def test_single_process_needs_nothing(self, monkeypatch):
        from audiosignalprocess_tpu.parallel.launch import initialize

        calls = self._calls(monkeypatch)
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        # cluster markers that jax.distributed could auto-detect are
        # not read
        monkeypatch.setenv("SLURM_JOB_NODELIST", "a,b,c,d")
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
        assert initialize() is False
        assert initialize(num_processes=1) is False
        assert calls == []

    def test_process_args_without_coordinator_raise(self, monkeypatch):
        from audiosignalprocess_tpu.parallel.launch import initialize

        calls = self._calls(monkeypatch)
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        with pytest.raises(ValueError, match="coordinator"):
            initialize(num_processes=2, process_id=0)
        assert calls == []

    def test_explicit_coordinator(self, monkeypatch):
        from audiosignalprocess_tpu.parallel.launch import initialize

        calls = self._calls(monkeypatch)
        monkeypatch.setattr("jax.process_count", lambda: 2)
        assert initialize("localhost:9876", 2, 1) is True
        assert calls == [dict(coordinator_address="localhost:9876",
                              num_processes=2, process_id=1)]

    def test_coordinator_from_env(self, monkeypatch):
        from audiosignalprocess_tpu.parallel.launch import initialize

        calls = self._calls(monkeypatch)
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:9877")
        assert initialize(num_processes=2, process_id=0) is True
        assert calls[0]["coordinator_address"] == "localhost:9877"

    def test_errors_propagate(self, monkeypatch):
        import jax

        from audiosignalprocess_tpu.parallel.launch import initialize

        def boom(**kw):
            raise ValueError("no cluster")

        monkeypatch.setattr(jax.distributed, "initialize", boom)
        with pytest.raises(ValueError, match="no cluster"):
            initialize("localhost:9878", 2, 0)
