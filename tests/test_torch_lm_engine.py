"""The port's LM serving engine (``repro_torch.serving.engine``) and the
``lm`` launcher on the CPU: ``ServeEngine.generate`` against the JAX
``ServeEngine`` (float32 variants of the reduced yi-9b, qwen2.5-32b and
mistral-large-123b and tests/test_serve_engine.py's TINY: equal tokens), the
bfloat16 configs against the reference's lockstep wave driven by hand (equal
tokens up to the first whose reference top-2 margin is within 0.125, twice
the logit bound of tests/torch_lm_cases.py), the hand-rolled prefill and
greedy decode of tests/test_train_and_serve.py, and mirrors of
tests/test_serve_engine.py's wave, padding, fresh-cache and capacity tests.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch.launch import serve
from repro_torch.models.model import LMModel
from repro_torch.serving import Request, ServeEngine, decode_step
from repro_torch.serving import engine as engine_mod

MODELS = (*cases.ARCHS, "tiny")


@pytest.fixture(scope="module")
def tiny():
    """The port's TINY (bfloat16, as tests/test_serve_engine.py's) on the CPU."""
    return LMModel(cases.TINY, device="cpu").init(0)


def _prompts(n, lo=3, hi=8, seed=0):
    return cases.prompts(cases.TINY.vocab_size, n, lo, hi, seed)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", MODELS)
def test_generate_matches_reference_float32(name):
    ref, params, _, port = cases.model_pair(name, "float32",
                                            bias_seed=8 if "qwen" in name else None)
    prompts = cases.prompts(port.cfg.vocab_size, 3, seed=13)      # two waves, one padded
    want = RefServeEngine(ref, params, batch=2, max_len=24).generate(prompts, 6)
    got = ServeEngine(port, batch=2, max_len=24).generate(prompts, 6)
    assert got == want
    assert all(len(o) == 6 for o in got)


@pytest.mark.parametrize("name", MODELS)
def test_generate_matches_reference_bfloat16(name):
    ref, params, _, port = cases.model_pair(name, bias_seed=8 if "qwen" in name else None)
    prompts = cases.prompts(port.cfg.vocab_size, 2, seed=14)
    got = ServeEngine(port, batch=2, max_len=24).generate(prompts, 8)
    want = cases.reference_wave(ref, params, prompts, 8, 24)
    held = [cases.gated_prefix(g, w, m) for g, (w, m) in zip(got, want)]
    assert sum(held) > 0, "no token was held: every margin under the bound"


def test_greedy_matches_direct_decode():
    """Engine output == hand-rolled prefill + greedy decode (one token a step,
    tests/test_train_and_serve.py), on the port, and both == the reference's."""
    ref, params, ref_apply, port = cases.model_pair("tiny", "float32")
    prompt = np.asarray([5, 17, 42], np.int32)
    out = ServeEngine(port, batch=1, max_len=32).generate([prompt], max_new_tokens=5)[0]

    def direct(step, caches):
        for t in prompt[:-1]:
            _, caches = step(np.asarray([[t]], np.int32), caches)
        cur, toks = int(prompt[-1]), []
        for _ in range(5):
            lg, caches = step(np.asarray([[cur]], np.int32), caches)
            cur = int(np.argmax(np.asarray(lg)[0, -1]))
            toks.append(cur)
        return toks

    assert out == direct(lambda t, c: cases.port_logits(port, t, c), port.init_caches(1, 32))
    assert out == direct(lambda t, c: ref_apply(params, t, c), ref.init_caches(1, 32))


def test_decode_step_takes_the_first_of_tied_maxima():
    """jnp.argmax's rule: with bfloat16-rounded logits, ties are real."""
    model = LMModel(cases.TINY, device="cpu").init(0)
    with torch.no_grad():
        model.final_norm.fill_(-1.0)            # the normed state is 0: every logit 0
    _, nxt = decode_step(model, model.init_caches(2, 4), torch.tensor([[1], [2]]))
    assert nxt.tolist() == [0, 0]


# --------------------------------------------------------------------------
# tests/test_serve_engine.py, on the port
# --------------------------------------------------------------------------
class TestWaveAssembly:
    def test_requests_split_into_ceil_n_over_batch_waves(self, tiny):
        engine = ServeEngine(tiny, batch=2, max_len=64)
        seen = []
        inner = engine._run_wave

        def spy(wave):
            seen.append([r.request_id for r in wave])
            return inner(wave)

        engine._run_wave = spy
        outs = engine.generate(_prompts(5), max_new_tokens=2)
        assert len(seen) == 3                      # ceil(5 / 2)
        assert all(len(w) == 2 for w in seen)      # every wave full-width
        assert [rid for w in seen for rid in w] == [0, 1, 2, 3, 4, -1]
        assert len(outs) == 5                      # padding never returned

    def test_padded_slot_does_not_change_real_results(self, tiny):
        prompts = _prompts(3, seed=1)
        solo = ServeEngine(tiny, batch=1, max_len=64)
        batched = ServeEngine(tiny, batch=2, max_len=64)
        assert batched.generate(prompts, 4) == solo.generate(prompts, 4)

    def test_variable_length_prompts_batch_losslessly(self, tiny):
        prompts = [np.arange(2, dtype=np.int32), np.arange(11, dtype=np.int32)]
        wide = ServeEngine(tiny, batch=2, max_len=64)
        solo = ServeEngine(tiny, batch=1, max_len=64)
        assert wide.generate(prompts, 3) == solo.generate(prompts, 3)

    def test_empty_request_list(self, tiny):
        assert ServeEngine(tiny, batch=2, max_len=64).generate([], max_new_tokens=3) == []


class TestCacheReuse:
    def test_waves_start_on_fresh_caches(self, tiny):
        p = np.asarray([7, 3, 11], np.int32)
        outs = ServeEngine(tiny, batch=2, max_len=64).generate([p] * 5, max_new_tokens=4)
        assert all(o == outs[0] for o in outs)

    def test_generate_is_deterministic_across_calls(self, tiny):
        engine = ServeEngine(tiny, batch=2, max_len=64)
        prompts = _prompts(4, seed=2)
        assert engine.generate(prompts, 4) == engine.generate(prompts, 4)

    def test_one_decode_step_per_wave_position(self, tiny, monkeypatch):
        # the reference pins one jitted program for every wave; the port's
        # decode step is one function, called once per step of each wave's
        # horizon, on caches made fresh for the wave
        calls = []

        def counting(model, caches, tokens):
            calls.append((tokens.shape, caches[0].index))
            return decode_step(model, caches, tokens)

        monkeypatch.setattr(engine_mod, "decode_step", counting)
        prompts = _prompts(4, lo=2, hi=12, seed=4)
        ServeEngine(tiny, batch=2, max_len=64).generate(prompts, max_new_tokens=3)
        horizons = [max(len(p) + 2 for p in prompts[i:i + 2]) for i in (0, 2)]
        assert len(calls) == sum(horizons)
        assert {shape for shape, _ in calls} == {(2, 1)}
        assert [i for _, i in calls] == [*range(horizons[0]), *range(horizons[1])]


class TestErrorPropagation:
    def test_wave_exceeding_cache_capacity_fails_loudly(self, tiny):
        engine = ServeEngine(tiny, batch=1, max_len=8)
        with pytest.raises(AssertionError, match="cache capacity"):
            engine.generate([np.arange(6, dtype=np.int32)], max_new_tokens=4)

    def test_capacity_is_checked_per_wave_not_per_request(self, tiny):
        engine = ServeEngine(tiny, batch=2, max_len=8)
        with pytest.raises(AssertionError, match="cache capacity"):
            engine.generate([np.arange(2, dtype=np.int32), np.arange(6, dtype=np.int32)],
                            max_new_tokens=4)

    def test_request_records_tokens_up_to_max_new(self, tiny):
        engine = ServeEngine(tiny, batch=1, max_len=32)
        req = Request(0, np.asarray([1, 2, 3], np.int32), max_new_tokens=5)
        engine._run_wave([req])
        assert len(req.tokens) == 5
        assert all(0 <= t < cases.TINY.vocab_size for t in req.tokens)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_serve_lm_launcher_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["lm", "--device", "cpu", "--requests", "3", "--max-new", "4"])
    text = out.getvalue()
    assert rc == 0, text
    assert "3 requests, 12 tokens" in text and "yi-9b-reduced" in text and "device cpu" in text


def test_serve_lm_launcher_refuses_an_unported_arch():
    """As the reference's launcher, ``serve lm`` refuses an arch with a stub
    frontend: qwen2-vl-7b's inputs are embeddings, not tokens."""
    with pytest.raises(SystemExit, match="stub frontend"):
        serve.main(["lm", "--device", "cpu", "--arch", "qwen2-vl-7b"])


def test_serve_lm_launcher_serves_xlstm():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["lm", "--arch", "xlstm-350m", "--reduced", "--device", "cpu",
                         "--requests", "2", "--max-new", "4"])
    text = out.getvalue()
    assert rc == 0 and "2 requests, 8 tokens" in text and "xlstm-350m-reduced" in text, text


def test_float32_variant_runs_the_engine_on_the_float32_path():
    """A float32 config keeps the bfloat16 cache and reads it back as float32."""
    cfg = dataclasses.replace(cases.TINY, dtype="float32")
    model = LMModel(cfg, device="cpu").init(0)
    caches = model.init_caches(1, 4)
    assert caches[0].k.dtype == torch.bfloat16 and model.embed.dtype == torch.float32
    caches, nxt = decode_step(model, caches, torch.tensor([[3]]))
    assert caches[0].index == 1 and caches[0].k[0, 0].any() and 0 <= int(nxt) < cfg.vocab_size
