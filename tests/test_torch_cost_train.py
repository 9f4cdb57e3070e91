"""Train-step FLOPs of the port's cost model against the reference's HLO,
on the CPU: every smoke preset (B=2, S=64, remat off, AdamW, the cosine
schedule), the port's ``cost.step_cost`` on ``meta`` tensors against
``hlo_cost_from_text`` of the reference's compiled train step.  Exact,
but for two measured gaps (``TRAIN_GAP``, the port's count above the
HLO's): jamba +1,571,840 (+0.082 %) and rwkv6-3b +4,194,304 (+0.36 %),
backward products that XLA's compiled step does not count as ``dot``.
"""
import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config as jget
from repro.configs.base import InputShape as JShape
from repro.hlo import hlo_cost_from_text
from repro.models import init_model as jinit
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import make_schedule as jschedule
from repro.runtime import input_specs as jspecs
from repro.runtime import make_train_step as jtrain_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import InputShape
from repro_torch.cost import step_cost
from repro_torch.launch.dryrun import step_args
from repro_torch.optim import AdamWConfig, make_schedule
from repro_torch.runtime import make_train_step

B, S = 2, 64
TRAIN_GAP = {"jamba-v0.1-52b": 1_571_840, "rwkv6-3b": 4_194_304}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_flops_match_the_reference_hlo(arch):
    jcfg = jget(arch, "smoke")
    params = jax.eval_shape(lambda k: jinit(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    state = {"params": params,
             "opt": jax.eval_shape(lambda p: jadamw_init(p, JAdamWConfig()),
                                   params)}
    specs = jspecs(jcfg, JShape("t", S, B, "train"))
    step = jtrain_step(jcfg, JAdamWConfig(), jschedule("cosine", 3e-4, 100),
                       remat=False)
    hlo = jax.jit(step).lower(state, specs).compile().as_text()
    want = int(hlo_cost_from_text(hlo)["flops"])
    cfg = get_config(arch, "smoke")
    _, args = step_args(arch, cfg, InputShape("t", S, B, "train"))
    got = step_cost(make_train_step(cfg, AdamWConfig(),
                                    make_schedule("cosine", 3e-4, 100),
                                    remat=False), *args)["flops"]
    assert got - want == TRAIN_GAP.get(arch, 0), (arch, got, want)
