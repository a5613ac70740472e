"""The port's tuner (``repro_torch.tune``) and its roofline model against the
JAX package's (``repro.tune``, ``repro.core.roofline``), the H100 search
space, the plan cache, the modes, and ``tcec_matmul_auto``.

Under ``REPRO_CHIP=tpu-v5e`` both packages run the reference's rules, so
their analytic plans must agree exactly.  The H100 spec (the port's
default) describes the port's compiled kernels instead.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from subproc import run_python  # noqa: E402

from repro import tune as jtune  # noqa: E402
from repro.core import roofline as jroof  # noqa: E402
from repro.kernels.tcec_matmul import tcec_matmul_auto as jax_auto  # noqa: E402

from repro_torch import tune  # noqa: E402
from repro_torch.core import roofline  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.tcec_matmul import tcec_matmul_auto  # noqa: E402
from repro_torch.tune.cache import PlanCache, plan_cache  # noqa: E402

SHAPES = [  # (batch, m, n, k, rhs_batched)
    (1, 512, 512, 512, True), (1, 64, 2048, 520, True),
    (1, 8, 128, 1000, True), (1, 256, 4864, 896, True),
    (8, 32, 32, 32, True), (256, 128, 128, 128, True),
    (64, 64, 64, 64, False), (1, 4096, 4096, 4096, True),
    (1, 1, 1, 1, True), (3, 40, 136, 72, False),
]
POLICIES = ["bf16x1", "bf16x3", "bf16x6", "fp32_vpu"]


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    tune.clear_plan_cache()
    yield tmp_path
    tune.clear_plan_cache()


# ---------------------------------------------------------------------------
# The reference's rules on the TPU spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("variants", [None, ("fused",)])
def test_analytic_plan_equals_reference_on_tpu_spec(monkeypatch, policy,
                                                    variants):
    monkeypatch.setenv("REPRO_CHIP", "tpu-v5e")
    with tune.tune_mode("analytic"), jtune.tune_mode("analytic"):
        for nb, m, n, k, rb in SHAPES:
            kw = dict(policy=policy, batch=nb, rhs_batched=rb,
                      variants=variants)
            ours = tune.matmul_plan(m, n, k, **kw)
            ref = jtune.matmul_plan(m, n, k, **kw)
            assert (ours.block, ours.variant, ours.predicted_us) == \
                (ref.block, ref.variant, ref.predicted_us), (nb, m, n, k)


def test_roofline_rules_equal_reference_on_reference_specs():
    for name in ("tpu-v5e", "a100-sxm4", "v100-sxm2"):
        chip, jchip = roofline.CHIPS[name], jroof.CHIPS[name]
        assert roofline.derive_block_caps(chip) == \
            jroof.derive_block_caps(jchip)
        assert roofline.staging_budget_bytes(chip) == \
            jroof.staging_budget_bytes(jchip)
        for variant in roofline.MATMUL_VARIANTS:
            for blk in ((8, 128, 128), (128, 128, 512), (64, 256, 256)):
                assert roofline.matmul_tile_footprint(
                    *blk, 3, variant, chip) == \
                    jroof.matmul_tile_footprint(*blk, 3, variant)
                kw = dict(batch=4, block=blk, variant=variant, passes=6,
                          n_words=3, rhs_batched=False)
                assert roofline.predict_matmul_time(
                    300, 500, 700, chip=chip, **kw) == \
                    jroof.predict_matmul_time(300, 500, 700, chip=jchip, **kw)


# ---------------------------------------------------------------------------
# The H100 spec: the port's compiled kernels
# ---------------------------------------------------------------------------

def test_h100_is_the_default_spec_with_published_figures(monkeypatch):
    monkeypatch.delenv("REPRO_CHIP", raising=False)
    chip = roofline.active_chip()
    assert chip is roofline.H100_SXM5 and chip.cuda
    assert (chip.matrix_tflops, chip.vector_tflops, chip.hbm_gbps,
            chip.staging_kib, chip.block_smem_kib) == \
        (989.0, 67.0, 3350.0, 228, 227)
    # 132 SMs x 128 B/clk x 1.98 GHz
    assert abs(chip.staging_gbps - 33454.08) < 1e-6
    assert roofline.staging_budget_bytes(chip) == 232448


@pytest.mark.parametrize("policy", POLICIES)
def test_h100_candidates_are_compiled_tiles_within_the_limit(monkeypatch,
                                                             policy):
    monkeypatch.delenv("REPRO_CHIP", raising=False)
    pol = get_policy(policy)
    cands = tune.matmul_candidates(40, 136, 72, pol)
    assert {c.variant for c in cands} == set(tune.matmul_variants(pol))
    assert len(cands) == len(_build.TILES) * len(tune.matmul_variants(pol))
    for c in cands:
        assert c.block in _build.TILES
        assert roofline.matmul_tile_footprint(*c.block, pol.n_words,
                                              c.variant) <= 227 * 1024
    with tune.tune_mode("analytic"):
        for nb, m, n, k, rb in SHAPES:
            plan = tune.matmul_plan(m, n, k, policy=pol, batch=nb,
                                    rhs_batched=rb)
            assert plan.block in _build.TILES
            assert plan.variant in tune.matmul_variants(pol)


def test_h100_footprints_are_the_kernels_shared_memory():
    """The paper's quantity at (128, 128, 32): fp32 source tiles for K2b
    (a ring of two slots, rows padded to pitches of 8 and 4 words mod 32),
    2 * n_words bf16 word tiles for K5 (1.5x at three words, before the
    row padding), two slots of them for K6."""
    fp = roofline.matmul_tile_footprint
    pad_ab, pad8 = (128 * 40 + 32 * 132), (128 * 40 + 32 * 136)
    assert fp(128, 128, 32, 3, "fused") == 2 * 4 * pad_ab == 74752
    assert fp(128, 128, 32, 3, "vpu") == fp(128, 128, 32, 3, "fused")
    # n_words A tiles and n_words B tiles of 2-byte words
    assert fp(128, 128, 32, 3, "staged") == 3 * 2 * pad8 == 56832
    assert fp(128, 128, 32, 3, "staged_db") == 2 * 56832
    assert fp(128, 128, 32, 2, "staged") == 2 * 2 * pad8
    # resident blocks: the least of the smem, thread, register (per
    # processing block) and block-count limits
    assert roofline.resident_blocks(35328, 512, 64) == 2
    assert roofline.resident_blocks(113664, 512, 128) == 1
    assert roofline.resident_blocks(5000, 32, 40) == 32
    assert roofline.resident_blocks(9216, 32, 96) == 20     # registers
    assert roofline.resident_blocks(10240, 32, 100) == 16   # registers
    assert roofline.resident_blocks(9216, 32, 80) == 22     # shared memory


def test_h100_plans_identical_across_processes():
    code = """
import json
from repro_torch import tune
out = []
for (m, n, k, b) in [(512, 512, 512, 1), (128, 128, 128, 256), (40, 136, 72, 3)]:
    for pol in ["bf16x1", "bf16x6", "fp32_vpu"]:
        p = tune.matmul_plan(m, n, k, policy=pol, batch=b)
        out.append([list(p.block), p.variant, p.predicted_us])
print(json.dumps(out))
"""
    outs = [run_python(code, devices=1) for _ in range(2)]
    assert outs[0] == outs[1] and json.loads(outs[0])


# ---------------------------------------------------------------------------
# Cache, modes
# ---------------------------------------------------------------------------

def test_cache_roundtrip_and_persistence(fresh_cache):
    c = PlanCache("h100-sxm5", "NVIDIA H100 80GB HBM3-torch2.11-cuda12.8")
    c.put("k1", {"block": [64, 64, 32], "variant": "staged",
                 "source": "measured"}, persist=True)
    c2 = PlanCache("h100-sxm5", "NVIDIA H100 80GB HBM3-torch2.11-cuda12.8")
    assert c2.get("k1")["variant"] == "staged"
    assert c2.path.is_file() and str(c2.path).startswith(str(fresh_cache))
    assert " " not in c2.path.name
    payload = json.loads(c2.path.read_text())
    assert payload["version"] == tune.SCHEMA_VERSION
    plan = tune.MatmulPlan((64, 64, 32), "staged", 1.5, 2.5, "measured",
                           (("fused", (32, 32, 32), 3.0),))
    assert tune.MatmulPlan.from_dict(
        json.loads(json.dumps(plan.to_dict()))) == plan


def test_cache_tolerates_corruption_and_mismatch(fresh_cache):
    c = PlanCache("chipY", "gpuA")
    c.path.parent.mkdir(parents=True, exist_ok=True)
    c.path.write_text("{not json!")
    assert c.get("anything") is None
    c.put("k", {"v": 1}, persist=True)
    assert PlanCache("chipY", "gpuA").get("k") == {"v": 1}
    stale = PlanCache("chipZ", "gpuA")
    stale.path.write_text(json.dumps(
        {"version": -1, "backend": "gpuA", "plans": {"k": {"v": 2}}}))
    assert PlanCache("chipZ", "gpuA").get("k") is None
    other = PlanCache("chipW", "gpuA")
    other.path.write_text(json.dumps(
        {"version": tune.SCHEMA_VERSION, "backend": "gpuB",
         "plans": {"k": {"v": 3}}}))
    assert PlanCache("chipW", "gpuA").get("k") is None


def test_cache_lru_and_registry(fresh_cache):
    c = PlanCache("chipL", "gpu", capacity=3)
    for i in range(5):
        c.put(f"k{i}", {"i": i}, persist=False)
    assert c.get("k0") is None and c.get("k4") == {"i": 4}
    assert plan_cache("c1", "gpu") is plan_cache("c1", "gpu")
    plan_cache("c1", "gpu").put("k", {"v": 1}, persist=True)
    tune.clear_plan_cache(disk=True)
    assert plan_cache("c1", "gpu").get("k") is None


def test_modes(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE", raising=False)
    assert tune.mode() == "analytic"
    monkeypatch.setenv("REPRO_TUNE", "off")
    assert tune.mode() == "off"
    assert tune.matmul_plan(256, 256, 256, policy="bf16x6") is None
    with tune.tune_mode("analytic"):
        assert tune.matmul_plan(256, 256, 256, policy="bf16x6").source == \
            "analytic"
    monkeypatch.setenv("REPRO_TUNE", "bogus")
    with pytest.raises(ValueError):
        tune.mode()


def test_analytic_mode_never_touches_disk(fresh_cache):
    with tune.tune_mode("analytic"):
        tune.matmul_plan(512, 512, 512, policy="bf16x6")
    assert list(fresh_cache.rglob("*")) == []


def test_measure_without_a_card_raises(fresh_cache):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    a = torch.ones(8, 16)
    with tune.tune_mode("measure"):
        with pytest.raises(RuntimeError, match="card"):
            tune.matmul_plan(64, 64, 64, policy="bf16x6")
        with pytest.raises(ValueError, match="CPU tensor"):
            tcec_matmul_auto(a, a.T.contiguous(), "bf16x6")
    assert list(fresh_cache.rglob("*")) == []


# ---------------------------------------------------------------------------
# tcec_matmul_auto against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["off", "analytic"])
@pytest.mark.parametrize("policy", ["bf16x3", "bf16x6", "fp32_vpu"])
@pytest.mark.parametrize("shapes", [((40, 72), (72, 136)),
                                    ((3, 16, 48), (48, 24))])
def test_tcec_matmul_auto_matches_reference(mode, policy, shapes):
    rng = np.random.default_rng(len(policy) + 7 * len(shapes[0]))
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    with tune.tune_mode(mode), jtune.tune_mode(mode):
        ref = jax_auto(jnp.asarray(a), jnp.asarray(b), policy,
                       interpret=True)
        ours = tcec_matmul_auto(torch.from_numpy(a), torch.from_numpy(b),
                                policy)
    assert tuple(ours.shape) == tuple(ref.shape)
    np.testing.assert_allclose(ours.double().numpy(),
                               np.asarray(ref, np.float64), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_measure_persists_and_second_plan_hits_the_cache(fresh_cache,
                                                              monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the measure tier times kernels")
    from repro_torch.kernels import launch_counts, reset_launch_counts
    monkeypatch.setenv("REPRO_TUNE_TOPK", "64")
    with tune.tune_mode("measure"):
        p1 = tune.matmul_plan(64, 64, 64, policy="bf16x6", batch=8)
        assert p1.source == "measured" and len(p1.trials) == 12
        tune.clear_plan_cache()
        reset_launch_counts()
        p2 = tune.matmul_plan(64, 64, 64, policy="bf16x6", batch=8)
        assert not any(launch_counts().values())
    assert p2 == p1 and list(fresh_cache.rglob("*.json"))
