"""bfloat16 sharded serving parts from one process at a near tie: bf16's
own rounding, not a fault of the port.  On the CPU, at the reduced
llama3.2-3b on a 1x2 mesh (B 16, a prompt of 20, cap 48, the same numpy
weights), the prefill's logits and one decode step's (fed the one-device
greedy token), in bfloat16:

- (a) the reference's sharded jitted prefill and decode
  (``build_workload`` jitted with its in/out shardings on a forced
  2-device host mesh, ``serve_resident``) against its own jitted step on
  one device;
- (b) the port's two gloo ranks against one port process.

The reference's sharded step parts from its single-device step by as
much as the port's ranks part from one process (a row-parallel
product's partial sums round differently from the whole product's), so
the parting of ``PERF.md``'s bf16 cells is bf16's, not the port's.  The
test pins that (b) stays within (a)'s size and that (a) is not zero.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mesh_cases as MC

CASE = {"name": "llama", "arch": "llama3.2-3b", "S": 20, "cap": 48,
        "seed": 0}

# the reference, one device and 1x2: prefill logits, then one decode
# step from the one-device cache and greedy token
JAX_STEPS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
""" + MC.SERVE_PARAMS + r"""
import json, sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.configs.base import InputShape, ModelConfig
from repro.launch import steps as ST
from repro.launch.mesh import make_test_mesh
from repro.models import registry as R

d, case = sys.argv[1], json.loads(sys.argv[2])
ref = np.load(os.path.join(d, "llama.npz"))
params = params_of(ref, jnp.asarray)
cfg = serve_config(get_config, case, ModelConfig)
B, cap = ref["tokens"].shape[0], int(ref["cap"])
toks = jnp.asarray(ref["tokens"].astype(np.int32))
kw = dict(serve_resident=True, dtype=jnp.bfloat16)
pf, _, pin, pout = ST.build_workload(
    cfg, InputShape("p", cap, B, "prefill"), **kw)
df, _, din, dout = ST.build_workload(
    cfg, InputShape("d", cap, B, "decode"), **kw)
_, cache = R.prefill(params, cfg, toks, cache_len_cap=cap,
                     dtype=jnp.bfloat16)
one_p = jax.jit(pf)(params, {"tokens": toks})
tok = jnp.argmax(one_p[:, -1], axis=-1)[:, None].astype(jnp.int32)
one_d, _ = jax.jit(df)(params, cache, tok)
mesh = make_test_mesh(1, 2)
with mesh:
    two_p = jax.jit(pf, in_shardings=ST._named(mesh, pin),
                    out_shardings=ST._named(mesh, pout))(
        params, {"tokens": toks})
    two_d, _ = jax.jit(df, in_shardings=ST._named(mesh, din),
                       out_shardings=ST._named(mesh, dout))(
        params, cache, tok)
np.savez(os.path.join(d, "jax_bf16.npz"),
         **{k: np.asarray(v, np.float32) for k, v in dict(
             one_p=one_p, one_d=one_d, two_p=two_p, two_d=two_d).items()})
"""

# the port: "1x1" one process (its greedy token saved), "1x2" a rank
PORT_STEPS = MC.SERVE_PARAMS + r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, d, spec = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
case = json.loads(sys.argv[6])
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as M
from repro_torch.launch.train import maybe_init_distributed
from repro_torch.models import registry as R
from repro_torch.weights import from_jax_params

cfg = serve_config(get_config, case, ModelConfig)
ref = np.load(os.path.join(d, "llama.npz"))
tree = params_of(ref)
toks = torch.from_numpy(ref["tokens"])
B, cap = toks.shape[0], int(ref["cap"])
kw = dict(dtype=torch.bfloat16, device="cpu")
with torch.no_grad():
    if world == 1:
        model = from_jax_params(tree, cfg, **kw)
        lp, cache = R.prefill(model, cfg, toks, cache_len_cap=cap)
        tok = lp[:, -1].argmax(-1, keepdim=True)
        ld, _ = R.decode_step(model, cfg, cache, tok)
        np.save(os.path.join(d, "tok.npy"), tok.numpy())
    else:
        assert maybe_init_distributed(f"127.0.0.1:{port}", world, rank,
                                      device="cpu")
        mesh = M.make_launch_mesh(spec, distributed=True)
        model = from_jax_params(tree, cfg, mesh=mesh, serve_resident=True,
                                **kw)
        tok = torch.from_numpy(np.load(os.path.join(d, "tok.npy")))
        lp, cache = R.prefill(model, cfg, toks, cache_len_cap=cap,
                              global_batch=B)
        ld, _ = R.decode_step(model, cfg, cache, tok)
np.savez(os.path.join(d, f"port_{spec}_{rank}.npz"), p=lp.float().numpy(),
         d=ld.float().numpy())
if world > 1:
    torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ranks and the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def partings(tmp_path_factory):
    """{"a": the reference's, "b": the port's} largest |logit| difference
    of the 1x2 run from the one-device run, at the prefill and the
    decode step, each relative to the one-device run's largest |logit|;
    and the greedy picks that differ."""
    d = str(tmp_path_factory.mktemp("mesh_serve_bf16"))
    MC.serve_reference(CASE, d)
    env = dict(os.environ, PYTHONPATH=os.path.join(MC.ROOT, "src"),
               JAX_PLATFORMS="cpu")
    case = json.dumps(CASE)
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_STEPS, d, case],
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    MC.wait(MC.spawn(d, "1x1", PORT_STEPS, case))
    MC.wait(MC.spawn(d, "1x2", PORT_STEPS, case))
    _, err = jax_run.communicate(timeout=420)
    assert jax_run.returncode == 0, err[-3000:]
    j = np.load(os.path.join(d, "jax_bf16.npz"))
    one = np.load(os.path.join(d, "port_1x1_0.npz"))
    two = [np.load(os.path.join(d, f"port_1x2_{r}.npz")) for r in range(2)]

    def parting(got, want):
        return (float(np.abs(got - want).max() / np.abs(want).max()),
                int((got[:, -1].argmax(-1) != want[:, -1].argmax(-1)).sum()))

    out = {"a": {}, "b": {}}
    for w in ("p", "d"):
        out["a"][w] = parting(j[f"two_{w}"], j[f"one_{w}"])
        out["b"][w] = parting(np.concatenate([r[w] for r in two], -1),
                              one[w])
    return out


def test_bf16_sharded_parting_is_bf16s_own(partings):
    for w in ("p", "d"):
        a, b = partings["a"][w][0], partings["b"][w][0]
        # the reference's own sharded step parts from its one device
        assert 0 < a < 2e-2, (w, partings)
        # and the port's ranks part from one process by no more than it
        assert b <= a, (w, partings)
