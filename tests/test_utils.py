"""Utility subsystem tests: metrics, logging, image IO, multihost shims."""
import json
import logging
import time

import numpy as np
import pytest

from weekend_raytracer.utils.image import _save_png_pure, save_png, save_ppm
from weekend_raytracer.utils.log import JsonFormatter, get_logger, log_event
from weekend_raytracer.utils.metrics import FpsCounter, StepTimer, profiler_trace


def test_fps_counter_window():
    """8-frame sliding window (reference main.rs:484-513)."""
    f = FpsCounter(window=8)
    assert f.average_fps() == 0.0
    for _ in range(20):
        f.update(0.02)  # 50 fps
    assert f.average_fps() == pytest.approx(50.0, rel=1e-6)
    f.update(0.1)  # one slow frame enters the window
    assert 30.0 < f.average_fps() < 50.0


def test_step_timer_throughput():
    t = StepTimer(rays_per_step=1000)
    with t.step():
        time.sleep(0.01)
    with t.step():
        time.sleep(0.02)
    assert t.total_seconds >= 0.03
    assert t.best_rays_per_sec >= t.mean_rays_per_sec > 0


def test_profiler_trace_noop():
    with profiler_trace(None):
        pass  # must be a harmless no-op without a log dir


def test_json_log_fields(capsys):
    rec = logging.LogRecord("weekend_raytracer.x", logging.INFO, "f", 1,
                            "hello %s", ("world",), None)
    rec.fields = {"rays": 42}
    line = JsonFormatter().format(rec)
    data = json.loads(line)
    assert data["msg"] == "hello world"
    assert data["rays"] == 42
    assert data["level"] == "info"


def test_get_logger_singleton_handler():
    a = get_logger("one")
    b = get_logger("two")
    root = logging.getLogger("weekend_raytracer")
    assert len(root.handlers) == 1
    log_event(a, "evt", x=1)  # must not raise


def test_pure_png_roundtrip(tmp_path):
    rs = np.random.RandomState(0)
    img = (rs.rand(12, 9, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "x.png")
    _save_png_pure(p, img)
    from PIL import Image

    back = np.asarray(Image.open(p).convert("RGB"))
    np.testing.assert_array_equal(back, img)


def test_save_ppm(tmp_path):
    img = np.zeros((4, 5, 3), dtype=np.uint8)
    img[1, 2] = [255, 128, 0]
    p = str(tmp_path / "x.ppm")
    save_ppm(p, img)
    data = open(p, "rb").read()
    assert data.startswith(b"P6\n5 4\n255\n")


def test_multihost_single_process():
    import jax

    from weekend_raytracer.parallel import multihost

    multihost.initialize(num_processes=1)  # no-op path
    mesh = multihost.global_mesh()
    assert mesh.shape["tiles"] * mesh.shape["spp"] == len(jax.devices())
    import jax.numpy as jnp

    acc = jnp.ones((6 * 4, 3), jnp.float32)
    out = multihost.gather_frame(acc, width=6, height=4)
    assert out is not None and out.shape == (24, 3)


# --- persistent compilation cache directory ---

@pytest.fixture
def cache_config():
    import jax

    saved = jax.config.jax_compilation_cache_dir
    yield jax.config
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_dir_follows_the_environment(monkeypatch, cache_config,
                                           tmp_path):
    from weekend_raytracer.utils import cache

    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    cache_config.update("jax_compilation_cache_dir", None)
    cache.enable_persistent_cache()
    # JAX reads the variable itself; no other directory is set in code
    assert cache_config.jax_compilation_cache_dir is None


def test_cache_dir_defaults_into_the_checkout(monkeypatch, cache_config):
    import os

    from weekend_raytracer.utils import cache

    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    cache_config.update("jax_compilation_cache_dir", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    cache.enable_persistent_cache()
    assert cache_config.jax_compilation_cache_dir == cache.DEFAULT_DIR


def test_cache_dir_set_by_the_caller_is_kept(monkeypatch, cache_config,
                                             tmp_path):
    from weekend_raytracer.utils import cache

    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    cache_config.update("jax_compilation_cache_dir", str(tmp_path))
    cache.enable_persistent_cache()
    assert cache_config.jax_compilation_cache_dir == str(tmp_path)


# --- device stamps for measurements ---

def test_require_gpu_refuses_the_cpu():
    from weekend_raytracer.utils.metrics import NoGpuError, require_gpu

    with pytest.raises(NoGpuError):
        require_gpu()


def test_card_name_and_power_limit_reads_nvidia_smi(monkeypatch):
    import subprocess

    from weekend_raytracer.utils import metrics

    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert metrics.card_name_and_power_limit() == (
        "NVIDIA H100 80GB HBM3, 700.00 W")
    assert "--query-gpu=name,power.limit" in seen["cmd"]


def test_device_stamp_fields(monkeypatch):
    from weekend_raytracer.utils import metrics

    monkeypatch.setattr(metrics, "card_name_and_power_limit",
                        lambda: "card, 1.00 W")
    stamp = metrics.device_stamp("xla")
    assert stamp["platform"] == "cpu"
    assert stamp["device_count"] == 8
    assert stamp["card"] == "card, 1.00 W"
    assert stamp["backend"] == "xla"
    assert stamp["device_kind"]
