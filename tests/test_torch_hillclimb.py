"""The port's hill-climb harness (``repro_torch.launch.hillclimb``) against
the JAX package's: the same variant names, each variant's config equal to
JAX's field for field for every arch, a warm start replayed from a store
under a temp dir, and a record the JAX tool keyed never replayed here."""
import dataclasses
import json
import os

import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import hillclimb
from repro_torch.serving.profiling import ProfileStore

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jhc():
    """The JAX harness; its import prepends a forced device count to
    XLA_FLAGS, put back at once (this process keeps one CPU device)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import hillclimb as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


def test_variant_names_equal_jax(jhc):
    assert list(hillclimb.VARIANTS) == list(jhc.VARIANTS)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_variant_configs_equal_jax(jhc, arch):
    for name, fn in hillclimb.VARIANTS.items():
        t = dataclasses.asdict(fn(ARCHS[arch]))
        j = dataclasses.asdict(jhc.VARIANTS[name](J_ARCHS[arch]))
        assert t == j, (arch, name)


@pytest.fixture
def reduced_archs(monkeypatch):
    """The harness dry-runs the reduced config of the arch it is given."""
    monkeypatch.setattr(hillclimb, "get_arch",
                        lambda name: reduced(ARCHS[name]))


def _run(tmp_path, variant, store):
    out = tmp_path / "hc.jsonl"
    rc = hillclimb.main(["--arch", "internlm2-1.8b", "--shape",
                         "decode_32k", "--variant", variant,
                         "--profile-store", str(store), "--out", str(out),
                         "--device", "cpu"])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    return rc, recs[-1]


def test_warm_start_replays_from_the_store(tmp_path, reduced_archs):
    store = tmp_path / "profiles.json"
    rc, cold = _run(tmp_path, "int8_cache", store)
    assert rc == 0 and cold["status"] == "ok" and "warm_start" not in cold
    assert cold["tag"] == "int8_cache"
    saved = ProfileStore(str(store))
    rec = saved.get(**hillclimb.store_key("internlm2-1.8b", "decode_32k",
                                          "single", "int8_cache"))
    assert rec["key"]["backend"] == "torch"
    rc, warm = _run(tmp_path, "int8_cache", store)
    assert rc == 0 and warm["warm_start"] is True
    assert {k: v for k, v in warm.items() if k != "warm_start"} == cold


def test_jax_keyed_record_is_not_replayed(tmp_path, reduced_archs):
    """The JAX tool keys its records without ``backend``: one it wrote
    into the shared file must not stand in for the port's dry run."""
    store = ProfileStore(str(tmp_path / "profiles.json"))
    jax_rec = {"arch": "internlm2-1.8b", "shape": "decode_32k",
               "mesh": "single", "status": "ok", "tag": "baseline",
               "memory": {"per_device_total_gb": -1.0}}
    store.put(jax_rec, kind="hillclimb", arch="internlm2-1.8b",
              shape="decode_32k", mesh="single", variant="baseline")
    store.save()
    rc, rec = _run(tmp_path, "baseline", store.path)
    assert rc == 0 and "warm_start" not in rec
    assert rec["memory"]["per_device_total_gb"] > 0
    after = ProfileStore(store.path)
    assert len(after) == 2      # the JAX record kept, the port's added


def test_default_store_is_the_shared_file():
    from repro_torch.serving.profiling import default_profile_path
    assert ProfileStore().path == default_profile_path()
    assert default_profile_path().endswith(
        os.path.join("BENCH_artifacts", "kernel_profiles.json"))
