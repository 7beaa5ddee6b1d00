"""The slice test: the port's ``ServingEngine`` serves the reduced
llama3.2-3b with the same greedy tokens as the JAX ``ServingEngine`` from
the same weights, with more requests than slots (slots are reused), and
the launcher runs on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduce_config as jreduce_config
from repro.layers.common import materialize as jmaterialize
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.launch import serve
from repro_torch.serving import engine


def _model(**kw):
    jcfg = dataclasses.replace(jreduce_config(jget_config("llama3p2_3b")),
                               **kw)
    cfg = dataclasses.replace(reduce_config(get_config("llama3p2_3b")), **kw)
    jp = jmaterialize(jlm.param_specs(jcfg), jax.random.PRNGKey(0))
    tp = convert.lm_params_to_torch(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_engine_tokens_equal_the_jax_engine_with_slot_reuse(impl):
    jcfg, jp, cfg, tp = _model(num_layers=2, attn_impl=impl)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 7, 12, 3)]
    lengths = (6, 4, 6, 5, 6)
    jreqs = [jengine.Request(uid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, lengths))]
    jdone = jengine.ServingEngine(jcfg, jp, slots=2, max_seq=32).run(
        list(jreqs))
    reqs = [engine.Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, lengths))]
    eng = engine.ServingEngine(cfg, tp, slots=2, max_seq=32, device="cpu")
    done = eng.run(list(reqs))
    assert [r.uid for r in done] == [r.uid for r in jdone]
    for got, want in zip(reqs, jreqs):
        assert got.done and len(got.output) == want.max_new_tokens
        assert got.output == want.output, (got.uid, got.output, want.output)
    assert eng.active == [None, None]


def test_eos_and_cache_end_free_the_slot():
    jcfg, jp, cfg, tp = _model(num_layers=1)
    prompt = np.arange(1, 9, dtype=np.int32)
    eng = engine.ServingEngine(cfg, tp, slots=1, max_seq=12, device="cpu")
    first = engine.Request(uid=0, prompt=prompt, max_new_tokens=50)
    eng.run([first])
    assert len(first.output) == 4          # stops at the end of the cache
    eos = engine.Request(uid=1, prompt=prompt, max_new_tokens=50,
                         eos_id=first.output[1])
    eng.run([eos])
    assert eos.output == first.output[:2]  # ends on its EOS token
    jeos = jengine.Request(uid=1, prompt=prompt, max_new_tokens=50,
                           eos_id=first.output[1])
    jengine.ServingEngine(jcfg, jp, slots=1, max_seq=12).run([jeos])
    assert jeos.output == eos.output


def test_scatter_slot_matches_the_reference():
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(2, 3, 10, 2, 4)).astype(np.float32)
    one = rng.normal(size=(2, 1, 6, 2, 4)).astype(np.float32)
    want = jengine._scatter_slot(jnp.asarray(pool), jnp.asarray(one), 1)
    got = engine._scatter_slot(torch.from_numpy(pool.copy()),
                               torch.from_numpy(one), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_defaults_to_the_gpu(monkeypatch):
    _, _, cfg, tp = _model(num_layers=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServingEngine(cfg, tp)


def test_launcher_serves_on_the_cpu(capsys):
    serve.main(["--arch", "llama3.2-3b", "--device", "cpu", "--requests",
                "3", "--max-new", "4"])
    assert capsys.readouterr().out.startswith("3 requests, 12 tokens")
    with pytest.raises(NotImplementedError, match="w8"):
        serve.main(["--arch", "llama3.2-3b", "--device", "cpu", "--w8"])
