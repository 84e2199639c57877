"""Break down the end-to-end sampled step: sampler / subgraph build /
collate-numpy / device conversion / train step — then the fused
single-transfer producer for comparison.  Run with the default backend
(GPU) or JAX_PLATFORMS=cpu.

The fused path exists to delete the O(num_nodes) per-step costs and the
feature shipping (see data/sampled.py::_build_sampled_batch)."""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from connectome_gnn_jax.data import SampledNodeLoader, generate_spatial_graph
from connectome_gnn_jax.data.sampled import collate_sampled, _sample_seed
from connectome_gnn_jax.models import NodeGCN
from connectome_gnn_jax.train import Trainer

N = 1 << 20
g = generate_spatial_graph(N, degree=38, band=512, seed=0, shortcut_frac=0.1)
src, dst = g.edge_index
num = np.zeros(N); den = np.zeros(N)
np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
np.add.at(den, dst, g.edge_weight)
labels = ((num / (den + 1e-8)) > 0).astype(np.int32)

loader = SampledNodeLoader(g, labels, batch_size=1024, fanout=(10, 10),
                           seed=0, drop_last=True)
sampler = loader._sampler
rng = np.random.default_rng(0)

def timeit(fn, n=10):
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3

chunk = rng.choice(N, 1024, replace=False).astype(np.int64)

# 1. native sample (includes subgraph build in sampler.sample)
t_sample = timeit(lambda: sampler.sample(chunk, (10, 10), seed=1))

# 1b. native core only
from connectome_gnn_jax import native
t_native = timeit(lambda: native.sample_subgraph(
    sampler._order, sampler._starts, sampler._ends, sampler._src,
    g.num_nodes, g.num_edges, chunk, np.asarray((10, 10), np.int64), 1))

sub, ids = sampler.sample(chunk, (10, 10), seed=1)

# 2. collate (numpy fills + jnp.asarray conversions)
t_collate = timeit(lambda: collate_sampled(
    sub, ids, labels[chunk], num_seeds=1024, real_seeds=1024,
    node_budget=loader.node_budget, edge_budget=loader.edge_budget))

# 2b. collate numpy-only (monkeypatch jnp.asarray to identity)
import connectome_gnn_jax.data.sampled as sm
real_asarray = sm.jnp.asarray
class FakeJnp:
    asarray = staticmethod(lambda x: x)
sm.jnp, saved = FakeJnp, sm.jnp
t_collate_np = timeit(lambda: collate_sampled(
    sub, ids, labels[chunk], num_seeds=1024, real_seeds=1024,
    node_budget=loader.node_budget, edge_budget=loader.edge_budget))
sm.jnp = saved

batch = collate_sampled(sub, ids, labels[chunk], num_seeds=1024,
                        real_seeds=1024, node_budget=loader.node_budget,
                        edge_budget=loader.edge_budget)

# 3. train step alone (device), synced by fetch
trainer = Trainer(NodeGCN(in_channels=5, hidden_dim=64, num_layers=2))
def step():
    (trainer.params, trainer.state, trainer.opt_state, trainer._rng,
     loss, _, _) = trainer._train_step(
        trainer.params, trainer.state, trainer.opt_state, trainer._rng, batch)
    return loss
float(step())  # compile
t_step = timeit(lambda: float(step()))

# 4. fused producer: native sample_collate_into + single-transfer build
fused_loader = SampledNodeLoader(
    g, labels, batch_size=1024, fanout=(10, 10), seed=0, drop_last=True,
    fused=True,
)
t_fused = timeit(
    lambda: jax.tree_util.tree_leaves(
        fused_loader._sample_and_collate(chunk, 1, 1024)
    )
)

# 4b. fused native core alone (persistent handle, in-place buffers)
nb, eb = fused_loader.node_budget, fused_loader.edge_budget
bufs = dict(
    out_senders=np.empty(eb, np.int32),
    out_receivers=np.empty(eb, np.int32),
    out_weights=np.empty(eb, np.float32),
    out_node_ids=np.empty(nb, np.int32),
)
t_fused_native = timeit(
    lambda: fused_loader._sampler.sample_collate_into(
        chunk, (10, 10), 1, node_budget=nb, edge_budget=eb, **bufs
    )
)

# 4c. fused end-to-end step (producer + device step, fetch-synced)
fb = fused_loader._sample_and_collate(chunk, 1, 1024)
trainer2 = Trainer(NodeGCN(in_channels=5, hidden_dim=64, num_layers=2))
def fused_step():
    b = fused_loader._sample_and_collate(chunk, 1, 1024)
    (trainer2.params, trainer2.state, trainer2.opt_state, trainer2._rng,
     loss, _, _) = trainer2._train_step(
        trainer2.params, trainer2.state, trainer2.opt_state,
        trainer2._rng, b)
    return loss
float(fused_step())  # compile
t_fused_step = timeit(lambda: float(fused_step()))

print(f"platform           : {jax.devices()[0].platform}")
print(f"sampler.sample     : {t_sample:8.2f} ms")
print(f"  native core      : {t_native:8.2f} ms")
print(f"  py wrap (diff)   : {t_sample - t_native:8.2f} ms")
print(f"collate (w/ jnp)   : {t_collate:8.2f} ms")
print(f"  numpy only       : {t_collate_np:8.2f} ms")
print(f"  jnp conversion   : {t_collate - t_collate_np:8.2f} ms")
print(f"train step (fetch) : {t_step:8.2f} ms")
print(f"sum                : {t_sample + t_collate + t_step:8.2f} ms")
print("--- fused path ---")
print(f"fused producer     : {t_fused:8.2f} ms")
print(f"  native core      : {t_fused_native:8.2f} ms")
print(f"fused step (fetch) : {t_fused_step:8.2f} ms")
