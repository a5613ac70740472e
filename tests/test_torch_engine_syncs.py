"""The serving engine's control copies (``PagedServingEngine._dev``): greedy
streams of the port's engine on the CPU against the JAX package's engine
on identical weights, no pinned memory on the CPU, and on a card no host
sync from a decode tick but the token transfer.

On a card the engine stages the block table, ``seq_lens`` and the last
tokens through page-locked memory with non-blocking copies; on the CPU it
runs the plain ``as_tensor``, so nothing is pinned there.  Tests marked
``cuda`` need a card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.context import policy_scope as jax_scope  # noqa: E402
from repro.serving import PagedServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.context import policy_scope  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import PagedServingEngine  # noqa: E402

PAGE = 4
#: (prompt lengths, new tokens): three requests through two slots, so a
#: slot is evicted and refilled while the other decodes.
STREAM = ((9, 4, 6), 4)


def _configs():
    """(reference config, port config): reduced qwen2 with fp32 weights."""
    return (dataclasses.replace(jax_get_config("qwen2-0.5b", reduced=True),
                                param_dtype="float32"),
            dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                                param_dtype="float32"))


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [list(map(int, rng.integers(0, vocab, n))) for n in STREAM[0]]


def _drive(engine, prompts):
    for p in prompts:
        engine.submit(p, STREAM[1])
    return engine.run()


@pytest.mark.parametrize("policy", ["fp32_vpu", "bf16x6"])
def test_cpu_streams_equal_reference_engine(policy):
    jcfg, cfg = _configs()
    params = jm.init_params(jax.random.PRNGKey(1), jcfg)
    np_tree = jax.tree.map(np.asarray, params)
    model = params_from_jax(np_tree, cfg, device="cpu")
    prompts = _prompts(cfg.vocab)
    with jax_scope(policy):
        ref = _drive(JaxEngine(jcfg, jax.tree.map(jnp.asarray, np_tree),
                               page_size=PAGE, max_concurrency=2,
                               max_seq_len=16), prompts)
    with policy_scope(policy):
        eng = PagedServingEngine(cfg, model, page_size=PAGE,
                                 max_concurrency=2, max_seq_len=16,
                                 device="cpu")
        ours = _drive(eng, prompts)
    assert ours == {k: [int(t) for t in v] for k, v in ref.items()}
    assert eng.stats["prefills"] == 3
    assert eng.all_logits_finite


def test_cpu_engine_pins_nothing(monkeypatch):
    pinned = []
    real = torch.Tensor.pin_memory

    def recording(self, *args, **kw):
        pinned.append(tuple(self.shape))
        return real(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "pin_memory", recording)
    cfg = get_config("qwen2-0.5b", reduced=True)
    eng = PagedServingEngine(cfg, init_params(cfg, device="cpu"),
                             page_size=PAGE, max_concurrency=2,
                             max_seq_len=16, device="cpu")
    seen = []
    dev = eng._dev

    def watching(x, dtype=torch.int32):
        out = dev(x, dtype)
        seen.append(out)
        return out

    monkeypatch.setattr(eng, "_dev", watching)
    _drive(eng, _prompts(cfg.vocab))
    assert pinned == []
    assert seen and all(t.device.type == "cpu" and not t.is_pinned()
                        for t in seen)
    # The values are the host arrays', at the dtype asked for.
    t = eng._dev(np.array([[1, 2], [3, 4]], np.int32), torch.int64)
    assert t.dtype == torch.int64 and t.tolist() == [[1, 2], [3, 4]]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_engine(dev):
    """A reduced qwen2 engine on the card with every request prefilled and
    one decode tick made; the next ticks decode only."""
    cfg = get_config("qwen2-0.5b", reduced=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    eng = PagedServingEngine(cfg, init_params(cfg, gen, dev), page_size=PAGE,
                             max_concurrency=2, max_seq_len=32, device=dev)
    for p in _prompts(cfg.vocab)[:2]:
        eng.submit(p, 8)
    while eng.stats["decode_ticks"] == 0:
        eng.step()
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16x6", "bf16x6_pallas"])
def test_cuda_decode_tick_syncs_only_for_the_tokens(cuda_device, policy):
    with policy_scope(policy):
        eng = _card_engine(cuda_device)
        transfers = []
        host = eng._host_tokens

        def allowed(tokens):
            # The one sync a tick makes, as the reference does.
            torch.cuda.set_sync_debug_mode("default")
            try:
                transfers.append(tuple(tokens.shape))
                return host(tokens)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        eng._host_tokens = allowed
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            plan = eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert plan.decode and not plan.prefill
    assert len(transfers) == 1


@pytest.mark.cuda
def test_cuda_host_writes_after_a_copy_do_not_reach_it(cuda_device):
    """The host rewrites its control arrays right after a tick's copies
    are enqueued, while the stream is still busy: each copy still carries
    the values it was given."""
    with policy_scope("bf16x6"):
        eng = _card_engine(cuda_device)
        copies = []
        dev = eng._dev

        def scribbling(x, dtype=torch.int32):
            src = np.array(x)           # the array this copy is given
            out = dev(src, dtype)
            copies.append((src.copy(), out))
            src[...] = -7               # rewritten before the copy runs
            return out

        eng._dev = scribbling
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)   # the stream stays busy
            eng.step()
        torch.cuda.synchronize()
    assert len(copies) == 9
    for want, got in copies:
        np.testing.assert_array_equal(got.cpu().numpy(), want)
