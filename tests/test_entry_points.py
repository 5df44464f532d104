"""Measurement entry points: GPU-only device checks and the compile cache.

bench.py, bench_configs.py and chip_smoke.py measure on the GPU only; on
this CPU test host each must refuse to run rather than fall back. All of
it is called in-process.
"""

import os
import sys

import jax
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def test_chip_smoke_refuses_cpu():
    import chip_smoke

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no GPU found"):
        chip_smoke.check_device()


def test_chip_smoke_main_exits_before_any_result(capsys):
    import chip_smoke

    with pytest.raises(SystemExit, match="no GPU found"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu_device():
    import bench

    with pytest.raises(SystemExit, match="no GPU found"):
        bench.main()


def test_bench_configs_records_refuse_cpu():
    import bench_fixtures

    assert bench_fixtures.device_record()["platform"] == "cpu"
    with pytest.raises(SystemExit, match="no GPU found"):
        bench_fixtures.require_gpu()


class TestCompileCache:
    def test_env_var_is_honoured(self, monkeypatch, tmp_path):
        from mapmerge_tpu.utils import compile_cache

        calls = []
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(
            jax.config, "update", lambda *a: calls.append(a)
        )
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert calls == []  # JAX reads the variable itself; nothing set

    def test_default_is_fixed_path_in_checkout(self, monkeypatch):
        from mapmerge_tpu.utils import compile_cache

        calls = []
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(
            jax.config, "update", lambda *a: calls.append(a)
        )
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(os.path.realpath(ROOT), ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
        assert compile_cache.enable_compile_cache() == path  # stable


class TestMultihostCardChoice:
    """multihost.initialize opens one card per process when the launcher
    gives the process's local rank; jax.distributed itself is stubbed."""

    @staticmethod
    def _init(monkeypatch):
        from mapmerge_tpu.parallel import multihost

        calls = []
        monkeypatch.setattr(
            jax.distributed, "initialize", lambda **kw: calls.append(kw)
        )
        multihost.initialize("localhost:1234", num_processes=4, process_id=3)
        assert len(calls) == 1
        return calls[0]

    def test_local_rank_picks_the_card(self, monkeypatch):
        monkeypatch.setenv("LOCAL_RANK", "2")
        kw = self._init(monkeypatch)
        assert kw["local_device_ids"] == [2]
        assert kw["process_id"] == 3 and kw["num_processes"] == 4

    def test_no_local_rank_leaves_cards_to_jax(self, monkeypatch):
        monkeypatch.delenv("LOCAL_RANK", raising=False)
        kw = self._init(monkeypatch)
        assert "local_device_ids" not in kw
        assert kw["coordinator_address"] == "localhost:1234"
