"""Multi-process execution layer tests.

Unit tests cover the shard-selection arithmetic (each process materializes
only its shards, and the shards tile the single-process result exactly).
The real cross-process dryrun — ≥2 OS processes joined via
``jax.distributed.initialize`` with gloo collectives, running the
unmodified shard_map steps — lives in ``benchmarks/multiprocess.py`` and
is executed here as a subprocess, asserting numerical agreement with the
single-process 8-virtual-device run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from connectome_gnn_jax.data import (
    ConnectomeDataLoader,
    generate_dataset,
    generate_spatial_graph,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


class TestLoaderProcessSharding:
    def test_local_shards_tile_the_global_stack(self):
        graphs = generate_dataset(num_subjects=16, num_regions=20, seed=0)
        full = ConnectomeDataLoader(
            graphs, batch_size=16, shuffle=False, num_shards=8
        )
        batches = [next(iter(full))]
        for p in range(4):
            loader = ConnectomeDataLoader(
                graphs, batch_size=16, shuffle=False, num_shards=8,
                process_index=p, process_count=4,
            )
            batches.append(next(iter(loader)))
        for g_leaf, *locals_ in zip(
            *(map(np.asarray, _leaves(b)) for b in batches)
        ):
            np.testing.assert_array_equal(
                g_leaf, np.concatenate(locals_, axis=0)
            )
            assert all(l.shape[0] == 2 for l in locals_)

    def test_shuffle_agrees_across_processes(self):
        graphs = generate_dataset(num_subjects=16, num_regions=20, seed=0)
        full = ConnectomeDataLoader(
            graphs, batch_size=8, shuffle=True, seed=3, num_shards=4
        )
        full.set_epoch(2)
        part = ConnectomeDataLoader(
            graphs, batch_size=8, shuffle=True, seed=3, num_shards=4,
            process_index=1, process_count=2,
        )
        part.set_epoch(2)
        for fb, pb in zip(full, part):
            for gl, ll in zip(_leaves(fb), _leaves(pb)):
                np.testing.assert_array_equal(np.asarray(gl)[2:4], ll)

    def test_validation_errors(self):
        graphs = generate_dataset(num_subjects=4, num_regions=20, seed=0)
        with pytest.raises(ValueError, match="together"):
            ConnectomeDataLoader(graphs, num_shards=4, process_index=0)
        with pytest.raises(ValueError, match="requires num_shards"):
            ConnectomeDataLoader(graphs, process_index=0, process_count=2)
        with pytest.raises(ValueError, match="divisible"):
            ConnectomeDataLoader(
                graphs, batch_size=4, num_shards=4,
                process_index=0, process_count=3,
            )
        with pytest.raises(ValueError, match="out of range"):
            ConnectomeDataLoader(
                graphs, batch_size=4, num_shards=4,
                process_index=2, process_count=2,
            )


class TestPartitionerShardRange:
    def _graph(self, shortcut_frac=0.0):
        g = generate_spatial_graph(
            96, degree=4, band=12, seed=1, shortcut_frac=shortcut_frac
        )
        labels = (g.degree() > np.median(g.degree())).astype(np.int32)
        return g, labels

    def test_partition_graph_range_is_a_slice(self):
        from connectome_gnn_jax.parallel import partition_graph

        g, labels = self._graph()
        full = partition_graph(g, 8, node_labels=labels)
        for lo, hi in ((0, 4), (4, 8), (2, 6)):
            part = partition_graph(
                g, 8, node_labels=labels, shard_range=(lo, hi)
            )
            for f, p in zip(_leaves(full), _leaves(part)):
                np.testing.assert_array_equal(np.asarray(f)[lo:hi], p)

    def test_partition_banded_range_is_a_slice(self):
        from connectome_gnn_jax.ops import to_banded
        from connectome_gnn_jax.parallel import partition_banded

        g, labels = self._graph()
        a = to_banded(
            g.edge_index[0], g.edge_index[1], g.edge_weight, g.num_nodes,
            block=8, bandwidth=2,
        )
        full = partition_banded(a, g.node_features, 4, labels=labels)
        for lo, hi in ((0, 2), (2, 4)):
            part = partition_banded(
                a, g.node_features, 4, labels=labels, shard_range=(lo, hi)
            )
            for f, p in zip(_leaves(full), _leaves(part)):
                np.testing.assert_array_equal(np.asarray(f)[lo:hi], p)

    def test_partition_hybrid_range_is_a_slice(self):
        from connectome_gnn_jax.ops import to_hybrid
        from connectome_gnn_jax.parallel import partition_hybrid

        g, labels = self._graph(shortcut_frac=0.25)
        h = to_hybrid(
            g.edge_index[0], g.edge_index[1], g.edge_weight, g.num_nodes,
            block=8, bandwidth=1,
        )
        full = partition_hybrid(h, g.node_features, 4, labels=labels)
        assert (np.asarray(full.rem_weights) > 0).any()
        for lo, hi in ((0, 2), (2, 4)):
            part = partition_hybrid(
                h, g.node_features, 4, labels=labels, shard_range=(lo, hi)
            )
            for f, p in zip(_leaves(full), _leaves(part)):
                np.testing.assert_array_equal(np.asarray(f)[lo:hi], p)


@pytest.mark.slow
class TestCrossProcessDryrun:
    def test_two_processes_match_single_process(self, tmp_path):
        """Launch the real 2-process (gloo) dryrun; every program's losses
        and final params must agree with the single-process run."""
        out = tmp_path / "mp.json"
        proc = subprocess.run(
            [
                sys.executable,
                os.path.join(REPO, "benchmarks", "multiprocess.py"),
                "--procs", "2", "--out", str(out),
            ],
            capture_output=True,
            text=True,
            timeout=540,
        )
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
        artifact = json.loads(out.read_text())
        assert artifact["ok"] is True
        assert set(artifact["programs"]) == {
            "dp", "banded", "hybrid", "sampled_dp", "device_sampled_dp",
            "device_sampled_dp_scanned", "graph_sharded", "trainer_fit"
        }
        # the scanned epoch removes per-step HOST DISPATCH;
        # per-optimizer-step collective latency remains.  CPU-load
        # variance makes tight ratios flaky, so assert only the
        # direction (never slower) with headroom
        t = artifact["timing"]
        assert (
            t["device_sampled_dp_scanned"]["single_process_step_s"]
            < 1.1 * t["device_sampled_dp"]["single_process_step_s"]
        )
        assert (
            t["device_sampled_dp_scanned"]["multi_process_step_s"]
            < 1.5 * t["device_sampled_dp"]["multi_process_step_s"]
        )
        # the graph-sharded compacted exchange crossed a real process
        # boundary and stayed exact (no capacity overflow)
        gs = artifact["multiprocess"]["graph_sharded"]
        assert gs["compaction"]["overflow_per_step"] == [0, 0]
        # plan_compaction ran on BOTH sides of the process boundary and
        # derived the identical per-stage config, exact on real steps
        gp = gs["compaction_planned"]
        ref_p = artifact["reference_single_process"]["graph_sharded"][
            "compaction_planned"
        ]
        assert gp == ref_p
        assert gp["overflow_per_step"] == [0, 0]
        for prog, d in artifact["drift"].items():
            assert d["max_rel_err"] <= d["bound"], prog
        for prog, t in artifact["timing"].items():
            assert t["multi_process_step_s"] > 0
            assert t["total_comm_bytes"] > 0
