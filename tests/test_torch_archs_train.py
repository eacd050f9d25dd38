"""Port parity, training the decoder configurations beyond qwen3
(``deepseek_67b``, ``chatglm3_6b``, ``gemma3_27b``, ``deepseek_moe_16b``,
``moonshot_v1_16b_a3b``): three ``make_train_step`` AdamW steps at SMOKE
width (fp32, ACDC projections on the ``pallas`` method; MoE configs add
the 0.01 load-balance loss) against the reference's jitted train step on
bridged state: loss, grad_norm and update_norm each step, every parameter
and moment at the end (fp32 atol 2e-4, rtol 1e-3,
tests/test_kernel_grads.py:248).  The reference runs its Pallas kernels
in interpret mode (under ``jax.vmap`` over the experts), as its own tests
do; the port's kernel wrappers run their plain versions on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import steps as jsteps
from repro.launch.train import SELL_GROUPS as J_SELL_GROUPS
from repro.models import get_model as jget
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.optim.optimizers import tree_paths
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.dist import steps as tsteps
from repro_torch.models import get_model as tget
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)
ARCHS = ("deepseek_67b", "chatglm3_6b", "gemma3_27b", "deepseek_moe_16b",
         "moonshot_v1_16b_a3b")


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    jcfg, tcfg = (jreg.with_sell(jreg.get_smoke_config(arch), "acdc",
                                 method="pallas"),
                  treg.with_sell(treg.get_smoke_config(arch), "acdc",
                                 method="pallas"))
    jm, tm = jget(jcfg), tget(tcfg)
    ocfg = dict(kind="adamw", lr=3e-3, groups=J_SELL_GROUPS)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg),
                             jsched.cosine_schedule(3e-3, 1, 6))
    to = topt.make_optimizer(topt.OptimizerConfig(**ocfg),
                             tsched.cosine_schedule(3e-3, 1, 6))
    jstate = jsteps.init_state(jm, jcfg, jo, jax.random.PRNGKey(0))
    tstate = bridge.state_to_torch(_flat(jstate), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(jm, jcfg, jo, 1))
    tstep = tsteps.make_train_step(tm, tcfg, to, 1)
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                    global_batch=4))
    for step in range(3):
        batch = {n: np.array(v) for n, v in data.batch_at(step).items()}
        jstate, jmet = jstep(jstate, {n: jnp.asarray(v)
                                      for n, v in batch.items()})
        tstate, tmet = tstep(tstate, {n: torch.from_numpy(v)
                                      for n, v in batch.items()})
        for name in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                       err_msg=f"{name} step {step}", **F32)
    want = _flat(jstate)
    got = bridge.state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **F32)
