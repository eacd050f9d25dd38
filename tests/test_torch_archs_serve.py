"""Port parity, serving the decoder configurations beyond qwen3: greedy
streams of ``repro_torch.serving.Engine`` against ``repro.serving.Engine``
token for token, at SMOKE width (fp32, ACDC projections on ``pallas``),
on weights bridged from the live reference's ``init``:

* every new arch, dense and paged (4-token pages);
* speculative paged serving at ``spec_k = 4`` (T = 5 verify rows a
  query head) on ``deepseek_67b`` (smoke group 8: 40 rows a KV head) and
  ``chatglm3_6b`` (smoke group 4: 20 rows), past the 16 rows of one
  paged-attention row block, built without refusal.

The reference runs its Pallas kernels in interpret mode, as its own tests
do.  Paged MoE runs use the reference's paged-attention kernel too
(``FORCE_FUSED``): the MoE's capacity couples the batch's rows, so a
parked row's attention output (the kernel attends it to its new tokens
only, the reference's CPU gather route to every stale key of its table)
reaches the live rows' routing; the port computes the kernel's function.
"""

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.kernels import paged_attn as jpaged_attn
from repro.models import get_model as jget
from repro.optim.optimizers import tree_paths
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import get_model as tget
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest

from _torch_clock import StepClock
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("deepseek_67b", "chatglm3_6b", "gemma3_27b", "deepseek_moe_16b",
         "moonshot_v1_16b_a3b")


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


def _prompts(vocab):
    rs = np.random.RandomState(7)
    return [rs.randint(0, vocab, size=rs.randint(4, 12)).tolist()
            for _ in range(5)]


def _serve_both(arch, **kw):
    jcfg = jreg.with_sell(jreg.get_smoke_config(arch), "acdc",
                          method="pallas")
    tcfg = treg.with_sell(treg.get_smoke_config(arch), "acdc",
                          method="pallas")
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(_flat(jp), device="cpu")
    kw = dict(n_slots=2, max_len=24, max_prompt_len=12, **kw)
    out = []
    for eng_cls, req_cls, model, cfg, params in (
            (JEngine, JRequest, jm, jcfg, jp),
            (TEngine, TRequest, tm, tcfg, tp)):
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(_prompts(cfg.vocab_size))]
        eng = eng_cls(model, cfg, params, clock=StepClock(), **kw)
        eng.run(reqs, max_ticks=400)
        out.append(([list(map(int, r.generated)) for r in reqs],
                    [r.finish_reason for r in reqs],
                    (int(eng.stats["drafted"]), int(eng.stats["accepted"]))))
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_identical_to_reference(arch, paged, monkeypatch):
    kw = dict(paged=True, block_size=4) if paged else {}
    if paged and treg.get_smoke_config(arch).n_experts:
        monkeypatch.setattr(jpaged_attn, "FORCE_FUSED", True)
    want, got = _serve_both(arch, **kw)
    assert got == want
    assert sum(map(len, got[0])) == 40


@pytest.mark.parametrize("arch", ["deepseek_67b", "chatglm3_6b"])
def test_paged_speculative_engine_past_one_row_block(arch):
    cfg = treg.get_smoke_config(arch)
    rows = cfg.n_heads // cfg.n_kv_heads * 5
    assert rows > 16
    want, got = _serve_both(arch, paged=True, block_size=4, spec_k=4)
    assert got == want
    assert sum(map(len, got[0])) == 40 and got[2][0] > 0
