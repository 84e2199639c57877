"""Activation-parity tests against the PyTorch reference implementation.

These tests load the reference suite from ``/root/reference`` (read-only),
generate identical data, transplant the reference's initialized weights into
this framework via ``params_from_reference_state_dict``, and assert per-layer
``allclose`` on identical batches — the parity gate from BASELINE.json.

Skipped automatically when the reference checkout or torch is unavailable.
"""

import os
import sys

import numpy as np
import pytest

REFERENCE_PATH = "/root/reference"

torch = pytest.importorskip("torch")
if not os.path.isdir(os.path.join(REFERENCE_PATH, "connectome_gnn")):
    pytest.skip("reference checkout not available", allow_module_level=True)

sys.path.insert(0, REFERENCE_PATH)

from connectome_gnn.graph import collate_graphs as ref_collate  # noqa: E402
from connectome_gnn.models import (  # noqa: E402
    GCNConnectome as RefGCN,
    GraphSAGEConnectome as RefSAGE,
)
from connectome_gnn.synthetic import (  # noqa: E402
    generate_connectome as ref_generate_connectome,
    generate_dataset as ref_generate_dataset,
)

import jax  # noqa: E402

from connectome_gnn_jax.data import collate_graphs, generate_dataset  # noqa: E402
from connectome_gnn_jax.models import (  # noqa: E402
    GCNConnectome,
    GraphSAGEConnectome,
    params_from_reference_state_dict,
)


def state_dict_numpy(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def paired_batches():
    """The same 8 subjects, packed by both frameworks."""
    ref_graphs = ref_generate_dataset(num_subjects=8, num_regions=30, seed=42)
    my_graphs = generate_dataset(num_subjects=8, num_regions=30, seed=42)
    return ref_collate(ref_graphs), collate_graphs(my_graphs)


class TestGeneratorParity:
    def test_single_graph_bitwise_topology(self):
        for seed in (0, 7, 42, 987654):
            ref = ref_generate_connectome(seed=seed)
            mine = __import__(
                "connectome_gnn_jax.data.synthetic", fromlist=["generate_connectome"]
            ).generate_connectome(seed=seed)
            assert np.array_equal(ref.edge_index.numpy(), mine.edge_index)
            assert np.array_equal(ref.edge_weight.numpy(), mine.edge_weight)
            assert np.allclose(
                ref.node_features.numpy(), mine.node_features, atol=1e-5
            )
            assert int(ref.label) == mine.label

    def test_dataset_fanout_parity(self):
        ref = ref_generate_dataset(num_subjects=12, num_regions=25, seed=42)
        mine = generate_dataset(num_subjects=12, num_regions=25, seed=42)
        for r, m in zip(ref, mine):
            assert r.subject_id == m.subject_id
            assert np.array_equal(r.edge_index.numpy(), m.edge_index)
            assert int(r.label) == m.label


class TestActivationParity:
    @pytest.mark.parametrize(
        "ref_cls,my_cls",
        [(RefGCN, GCNConnectome), (RefSAGE, GraphSAGEConnectome)],
        ids=["gcn", "sage"],
    )
    def test_eval_logits_allclose(self, paired_batches, ref_cls, my_cls):
        ref_batch, my_batch = paired_batches
        torch.manual_seed(0)
        ref_model = ref_cls(in_channels=5, hidden_dim=64, num_classes=2, num_layers=3)
        ref_model.eval()
        with torch.no_grad():
            ref_logits = ref_model(ref_batch).numpy()

        model = my_cls(in_channels=5, hidden_dim=64, num_classes=2, num_layers=3)
        params, state = params_from_reference_state_dict(
            state_dict_numpy(ref_model), num_layers=3
        )
        logits, _ = model.apply(params, state, my_batch, train=False)
        np.testing.assert_allclose(
            np.asarray(logits), ref_logits, rtol=1e-4, atol=1e-5
        )

    @pytest.mark.parametrize(
        "ref_cls,my_cls",
        [(RefGCN, GCNConnectome), (RefSAGE, GraphSAGEConnectome)],
        ids=["gcn", "sage"],
    )
    def test_eval_embeddings_allclose(self, paired_batches, ref_cls, my_cls):
        ref_batch, my_batch = paired_batches
        torch.manual_seed(1)
        ref_model = ref_cls(in_channels=5, hidden_dim=64, num_classes=2, num_layers=3)
        ref_model.eval()
        with torch.no_grad():
            ref_emb = ref_model.encode(ref_batch).numpy()

        model = my_cls(in_channels=5, hidden_dim=64, num_classes=2, num_layers=3)
        params, state = params_from_reference_state_dict(
            state_dict_numpy(ref_model), num_layers=3
        )
        emb, _ = model.encode(params, state, my_batch, train=False)
        np.testing.assert_allclose(np.asarray(emb), ref_emb, rtol=1e-4, atol=1e-5)

    def test_train_mode_batchnorm_stats_parity(self, paired_batches):
        """One train-mode forward (dropout off) must update BN running stats
        identically to the reference."""
        ref_batch, my_batch = paired_batches
        torch.manual_seed(2)
        ref_model = RefGCN(
            in_channels=5, hidden_dim=64, num_classes=2, num_layers=3, dropout=0.0
        )
        ref_model.train()
        with torch.no_grad():
            ref_logits = ref_model(ref_batch).numpy()
        ref_sd = state_dict_numpy(ref_model)  # post-forward running stats

        torch.manual_seed(2)
        ref_model_init = RefGCN(
            in_channels=5, hidden_dim=64, num_classes=2, num_layers=3, dropout=0.0
        )
        model = GCNConnectome(
            in_channels=5, hidden_dim=64, num_classes=2, num_layers=3, dropout=0.0
        )
        params, state = params_from_reference_state_dict(
            state_dict_numpy(ref_model_init), num_layers=3
        )
        logits, new_state = model.apply(
            params, state, my_batch, train=True, rng=jax.random.PRNGKey(0)
        )
        np.testing.assert_allclose(
            np.asarray(logits), ref_logits, rtol=1e-3, atol=1e-4
        )
        for i in range(3):
            np.testing.assert_allclose(
                np.asarray(new_state["norms"][i]["mean"]),
                ref_sd[f"batch_norms.{i}.running_mean"],
                rtol=1e-3,
                atol=1e-5,
            )
            np.testing.assert_allclose(
                np.asarray(new_state["norms"][i]["var"]),
                ref_sd[f"batch_norms.{i}.running_var"],
                rtol=1e-3,
                atol=1e-5,
            )


class TestDirectKernelParity:
    """Close the parity chain's transitive links (round-1 review, Weak #5):
    reference torch weights transplanted STRAIGHT into the fused
    kernels and into the RCM-ordered banded/hybrid path — no intermediate
    oracle in between."""

    @pytest.mark.parametrize(
        "ref_cls,kernel_name",
        [(RefGCN, "fused_gcn_forward"), (RefSAGE, "fused_sage_forward")],
        ids=["gcn", "sage"],
    )
    def test_torch_to_fused_logits(self, ref_cls, kernel_name):
        """torch eval logits == fused kernel logits (same weights,
        same subjects, dense layout, interpret mode)."""
        import connectome_gnn_jax.ops.fused_pallas as fp
        from connectome_gnn_jax.data import collate_dense

        ref_graphs = ref_generate_dataset(num_subjects=8, num_regions=30, seed=21)
        my_graphs = generate_dataset(num_subjects=8, num_regions=30, seed=21)
        ref_batch = ref_collate(ref_graphs)
        dense = collate_dense(my_graphs)

        torch.manual_seed(3)
        ref_model = ref_cls(in_channels=5, hidden_dim=64, num_classes=2, num_layers=3)
        ref_model.eval()
        with torch.no_grad():
            ref_logits = ref_model(ref_batch).numpy()

        params, state = params_from_reference_state_dict(
            state_dict_numpy(ref_model), num_layers=3
        )
        fused = getattr(fp, kernel_name)(
            params, state, dense.node_features, dense.adj, dense.node_mask,
            num_layers=3, interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(fused), ref_logits, rtol=1e-4, atol=1e-5
        )

    def test_torch_to_banded_rcm_activations(self):
        """torch per-node activations == RCM-ordered hybrid-banded path.

        Runs the reference GCN conv→BN→ReLU stack (eval, dropout off) on
        one WS graph, then the same weights through BandedNodeGCN over the
        RCM-reordered hybrid form (band bulk + shortcut remainder), with an
        identity head so the model output IS the last layer's activations.
        Asserts node-for-node equality under the permutation.
        """
        import jax.numpy as jnp

        from connectome_gnn_jax.data.reorder import (
            apply_ordering,
            reverse_cuthill_mckee,
        )
        from connectome_gnn_jax.data.synthetic import generate_connectome
        from connectome_gnn_jax.models.node_gcn import BandedNodeGCN
        from connectome_gnn_jax.ops.banded import to_hybrid

        seed, H, L = 33, 32, 3
        ref_g = ref_generate_connectome(num_regions=60, seed=seed)
        my_g = generate_connectome(num_regions=60, seed=seed)

        torch.manual_seed(4)
        ref_model = RefGCN(in_channels=5, hidden_dim=H, num_classes=2, num_layers=L)
        ref_model.eval()
        with torch.no_grad():
            x = ref_g.node_features
            for conv, bn in zip(ref_model.convs, ref_model.batch_norms):
                x = torch.relu(bn(conv(x, ref_g.edge_index, ref_g.edge_weight)))
            ref_act = x.numpy()  # [N, H]

        perm = reverse_cuthill_mckee(my_g.edge_index, my_g.num_nodes)
        g2 = apply_ordering(my_g, perm)
        hybrid = to_hybrid(
            g2.edge_index[0], g2.edge_index[1], g2.edge_weight,
            g2.num_nodes, block=8, bandwidth=2,
        )
        assert (np.asarray(hybrid.remainder_weights) > 0).any(), (
            "WS shortcuts should land in the remainder — otherwise this "
            "test is not exercising the hybrid path"
        )

        p_ref, s_ref = params_from_reference_state_dict(
            state_dict_numpy(ref_model), num_layers=L
        )
        params = {
            "convs": p_ref["convs"],
            "norms": p_ref["norms"],
            "head": {"kernel": jnp.eye(H), "bias": jnp.zeros(H)},
        }
        model = BandedNodeGCN(
            in_channels=5, hidden_dim=H, num_classes=H, num_layers=L
        )
        acts, _ = model.apply(
            params, {"norms": s_ref["norms"]}, hybrid,
            jnp.asarray(g2.node_features), train=False,
        )
        np.testing.assert_allclose(
            np.asarray(acts), ref_act[perm], rtol=1e-4, atol=1e-5
        )


class TestTraitParity:
    @pytest.mark.parametrize("trait_idx", [1, 2, 3, 4])
    def test_other_traits_bitwise(self, trait_idx):
        ref = ref_generate_connectome(seed=11, trait_idx=trait_idx)
        mine = __import__(
            "connectome_gnn_jax.data.synthetic", fromlist=["generate_connectome"]
        ).generate_connectome(seed=11, trait_idx=trait_idx)
        assert np.array_equal(ref.edge_index.numpy(), mine.edge_index)
        assert int(ref.label) == mine.label
