"""LM serving in the port: ``serve.engine.Engine`` / ``Request``,
``launch.steps`` and ``launch.serve``'s LM path, on the CPU, against the
JAX package's ``Engine`` where it has one.

  * the two ``Engine`` cases of ``tests/test_substrate.py`` (continuous
    batching with more requests than slots; ``slots=1`` greedy equal to a
    manual ``decode_step`` loop);
  * the port's ``Engine`` against the JAX ``Engine`` on the same
    parameters (drawn by the port, carried across by the bridge) and the
    same requests, an empty prompt among them: the same tokens, float32
    smoke, gemma-2b and llama3.2-3b;
  * ``python -m repro_torch.launch.serve --arch llama3.2-3b --smoke
    --device cpu`` through ``main(argv)``;
  * without a GPU ``Engine`` raises unless asked for the CPU.

The bf16 ``Engine`` on the card is a ``cuda``-marked case of
``tests/test_torch_cuda.py`` (which imports no JAX).
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jcb
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.configs import base as cb
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _manual_greedy(cfg, params, prompt, n, device, max_len=32):
    """Greedy decode of one prompt by hand through ``decode_step``."""
    cache = M.init_cache(cfg, 1, max_len, device)

    def step(tok, t):
        nonlocal cache
        with torch.no_grad():
            logits, cache = M.decode_step(
                params, cfg, torch.tensor([[tok]], device=device),
                torch.tensor([t], device=device), cache)
        return int(torch.argmax(logits[0, 0]))

    for t, tok in enumerate(prompt):
        nxt = step(tok, t)
    outs = [nxt]
    for i in range(n - 1):
        outs.append(step(outs[-1], len(prompt) + i))
    return outs


def test_engine_continuous_batching():
    cfg = cb.get_smoke_config("llama3.2-3b")
    params = M.init_params(cfg, 0, "cpu")
    eng = Engine(cfg, params, slots=2, max_len=32, device="cpu")
    reqs = [Request(rid=i, prompt=[1 + i, 2, 3], max_new=4)
            for i in range(5)]  # more requests than slots
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    assert all(len(r.out) >= 4 for r in reqs)
    assert eng.cache["k"].device.type == "cpu"


def test_engine_greedy_matches_manual_decode():
    cfg = cb.get_smoke_config("gemma-2b")
    params = M.init_params(cfg, 1, "cpu")
    eng = Engine(cfg, params, slots=1, max_len=32, device="cpu")
    req = Request(rid=0, prompt=[4, 8], max_new=3)
    eng.submit(req)
    eng.run()
    assert req.out[:3] == _manual_greedy(cfg, params, [4, 8], 3, "cpu")


def _requests(kind):
    return [kind(rid=i, prompt=p, max_new=n) for i, (p, n) in enumerate(
        [([1, 2, 3], 5), ([7], 4), ([], 3), ([9, 4, 4, 2], 6), ([5, 6], 4)])]


@pytest.mark.parametrize("arch", ["gemma-2b", "llama3.2-3b"])
def test_engine_matches_jax_engine(arch):
    """The same requests (an empty prompt among them, more than the slots)
    through both engines on the same parameters: the same tokens."""
    cfg, jcfg = cb.get_smoke_config(arch), jcb.get_smoke_config(arch)
    params = M.init_params(cfg, 3, "cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, M.params_to_numpy(params))
    mine, theirs = _requests(Request), _requests(JRequest)
    eng = Engine(cfg, M.params_from_numpy(M.params_to_numpy(params), cfg,
                                          "cpu"),
                 slots=2, max_len=16, device="cpu")
    jeng = JEngine(jcfg, jparams, slots=2, max_len=16)
    for r, jr in zip(mine, theirs):
        eng.submit(r)
        jeng.submit(jr)
    assert eng.run() == jeng.run()
    assert [r.out for r in mine] == [r.out for r in theirs]
    assert all(r.done for r in mine)


def test_steps_are_the_model_functions():
    cfg = cb.get_smoke_config("falcon-mamba-7b")
    params = M.init_params(cfg, 4, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = M.prefill(params, cfg, tokens)
        cache = M.init_cache(cfg, 2, 8, "cpu")
        wl, wc = M.decode_step(params, cfg, tokens[:, :1],
                               torch.tensor([0, 5]), cache)
    assert torch.equal(make_prefill_step(cfg)(params, dict(tokens=tokens)),
                       want)
    got, gc = make_serve_step(cfg)(params, dict(
        tokens=tokens[:, :1], pos=torch.tensor([0, 5]), cache=cache))
    assert torch.equal(got, wl)
    assert all(torch.equal(gc[k], wc[k]) for k in wc)


def test_serve_lm_cli_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "llama3.2-3b", "--smoke", "--device",
                             "cpu", "--requests", "5", "--max-new", "4",
                             "--slots", "2"])
    assert len(out["requests"]) == 5 and all(r.done for r in out["requests"])
    assert out["tokens"] == 20
    assert [r.prompt for r in out["requests"]][:2] == [[1, 2, 3], [2, 2, 4]]
    text = capsys.readouterr().out
    assert "served 5 requests, 20 tokens" in text and "on cpu" in text


def test_serve_lm_takes_every_lm_arch():
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "not-a-model"])
    for arch in cb.ARCH_IDS:
        out = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                                 "--requests", "1", "--max-new", "2",
                                 "--max-len", "16"])
        assert out["tokens"] == 2, arch


def test_engine_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    cfg = cb.get_smoke_config("gemma-2b")
    params = M.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="parameters on"):
        Engine(cfg, M.init_params(cfg, device="meta"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "gemma-2b", "--smoke"])
