"""Placement of JAX's persistent compilation cache (utils.device)."""
import os

import jax
import pytest

from gaml_tpu.utils import device


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.fixture
def not_pinned_to_cpu(monkeypatch):
    """JAX left to pick its platform, and no backend query allowed:
    placing the cache must not start a backend (on a GPU that would
    reserve the card's memory for a host-only run)."""
    before = jax.config.jax_platforms
    jax.config.update("jax_platforms", "cuda")

    def no_backend(*a, **kw):
        raise AssertionError("enable_compile_cache queried the devices")

    monkeypatch.setattr(jax, "devices", no_backend)
    yield
    jax.config.update("jax_platforms", before)


def test_cache_defaults_to_repo_dir(monkeypatch, restore_cache_dir,
                                    not_pinned_to_cpu):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    assert path == os.path.join(device.REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.exists(os.path.join(device.REPO_ROOT, "pyproject.toml"))


def test_cache_off_on_cpu(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    assert device.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_env_dir_is_left_to_jax(monkeypatch, tmp_path,
                                      restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no directory
    in code: JAX reads the variable itself."""
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_cli_sets_cache_once_at_entry(monkeypatch, tmp_path):
    """The CLI entry point places the cache once, before any work."""
    import gaml_tpu.cli as cli

    calls = []
    monkeypatch.setattr(device, "enable_compile_cache",
                        lambda: calls.append(1))
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert calls == []  # argument parsing exits before any set-up
    cfg = tmp_path / "nograph.cfg"
    cfg.write_text("t0=0.1\n")
    assert cli.main([str(cfg)]) == 1  # "Missing graph in config"
    assert calls == [1]
