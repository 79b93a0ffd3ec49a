"""The port's continuous-batching engine and serve launcher, on the CPU.

As `tests/test_serving.py` holds the reference engine to a greedy decode
of each request alone, these hold the port's engine to the port's own
solo decode, token for token: slot isolation, recycling and late
arrivals. The model's numbers against the JAX package are
`test_torch_models.py`'s.
"""

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine


@pytest.fixture(scope="module", params=["olmo-1b", "granite-8b"])
def lm(request):
    cfg = get_arch(request.param).reduced()
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _solo_reference(cfg, params, prompt, n_new, max_len=64):
    """Greedy decode of one request alone (the engine must match this)."""
    cache = T.init_cache(cfg, 1, max_len, "cpu")
    logits = None
    for t in prompt:
        logits, cache = T.decode_step(params, cache, torch.tensor([t]), cfg)
    out = []
    for _ in range(n_new):
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
        logits, cache = T.decode_step(params, cache, torch.tensor([tok]), cfg)
    return out


def test_engine_matches_solo_decode(lm):
    cfg, params = lm
    eng = ServingEngine(cfg, params, slots=2, max_len=64)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate([[5, 9, 2], [11, 3, 7, 1]])]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert eng.cache["k"].device.type == "cpu"
    for r in reqs:
        assert r.done and r.slot in (0, 1)
        assert r.output == _solo_reference(cfg, params, r.prompt, 6), r.uid


def test_slot_recycling_and_queueing(lm):
    """More requests than slots: later requests reuse recycled slots and
    still decode correctly despite the slot's previous occupant."""
    cfg, params = lm
    eng = ServingEngine(cfg, params, slots=1, max_len=64)
    reqs = [Request(uid=i, prompt=[3 + i, 8], max_new_tokens=4) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert eng.ticks == sum(len(r.prompt) - 1 + r.max_new_tokens for r in reqs)
    for r in reqs:
        assert r.output == _solo_reference(cfg, params, r.prompt, 4), r.uid


def test_interleaved_submission(lm):
    """A request arriving mid-flight joins without corrupting live slots."""
    cfg, params = lm
    eng = ServingEngine(cfg, params, slots=2, max_len=64)
    first = Request(uid=0, prompt=[4, 4, 4], max_new_tokens=8)
    eng.submit(first)
    for _ in range(4):
        eng.tick()
    late = Request(uid=1, prompt=[9, 1], max_new_tokens=5)
    eng.submit(late)
    eng.run_until_done()
    assert first.output == _solo_reference(cfg, params, first.prompt, 8)
    assert late.output == _solo_reference(cfg, params, late.prompt, 5)


def test_engine_stops_at_max_len(lm):
    cfg, params = lm
    eng = ServingEngine(cfg, params, slots=1, max_len=8)
    req = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=50)
    eng.submit(req)
    eng.run_until_done()
    assert req.done and len(req.output) == 8 - len(req.prompt)
    assert int(eng.cache["pos"][0]) == 8 - 1


def test_engine_takes_a_custom_sampler(lm):
    cfg, params = lm
    eng = ServingEngine(cfg, params, slots=2, max_len=32,
                        sampler=lambda logits: torch.zeros(logits.shape[0], dtype=torch.int64))
    req = Request(uid=0, prompt=[7], max_new_tokens=3)
    eng.submit(req)
    eng.run_until_done()
    assert req.output == [0, 0, 0]


def test_serve_launcher_on_the_cpu(capsys):
    out = serve.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--steps", "3", "--cache-len", "16"])
    assert out["device"] == "cpu" and out["steps"] == 3 and out["batch"] == 2
    assert out["tok_per_s"] > 0
    assert "granite-8b on cpu: 3 steps x batch 2" in capsys.readouterr().out
