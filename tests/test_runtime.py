"""Runtime helpers: explicit device pinning and the compile-cache path;
load-time refusal of removed configuration."""

import jax
import pytest

from vector_db_tpu import runtime


@pytest.fixture
def restore_platforms():
    yield
    jax.config.update("jax_platforms", "cpu")


def test_apply_device_gpu_raises_on_cpu_only(restore_platforms):
    with pytest.raises(RuntimeError, match="device: gpu"):
        runtime.apply_device("gpu")


@pytest.mark.parametrize("device", ["metal", "auto", ""])
def test_apply_device_unknown_raises(device):
    with pytest.raises(ValueError, match="unknown device"):
        runtime.apply_device(device)


def test_apply_device_cpu_pins_cpu(restore_platforms):
    runtime.apply_device("CPU")
    assert jax.devices()[0].platform == "cpu"


@pytest.fixture
def fresh_cache(monkeypatch):
    monkeypatch.setattr(runtime, "_CACHE_ENABLED", False)
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(fresh_cache, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_default(fresh_cache, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compilation_cache()
    assert path == str(runtime.DEFAULT_CACHE_DIR)
    assert runtime.DEFAULT_CACHE_DIR.name == ".jax_cache"
    assert runtime.DEFAULT_CACHE_DIR.parent.joinpath("chip_smoke.py").exists()
    assert jax.config.jax_compilation_cache_dir == path


def _service(tmp_path, index_cfg):
    from vector_db_tpu.services import IndexingService
    from vector_db_tpu.storage import InMemoryNodeStorage

    return IndexingService(
        storage=InMemoryNodeStorage(),
        config_path={"index": index_cfg},
        index_file=str(tmp_path / "i.npz"))


def test_service_accepts_config_mapping(tmp_path):
    svc = _service(tmp_path, {"type": "flat", "precision": "blocksel2p"})
    assert svc.index_type == "flat"
    assert svc.index.precision == "blocksel2p"


@pytest.mark.parametrize("adc", ["pallas", "pallas_interp"])
def test_service_refuses_removed_adc(tmp_path, adc):
    with pytest.raises(ValueError, match="adc"):
        _service(tmp_path, {"type": "ivf", "pq": {"chunks": 8, "adc": adc}})


@pytest.mark.parametrize("value", ["auto", True, False])
def test_service_refuses_merge_kernel(tmp_path, value):
    with pytest.raises(ValueError, match="merge_kernel"):
        _service(tmp_path, {"type": "hnsw",
                            "wide": {"merge_kernel": value}})
