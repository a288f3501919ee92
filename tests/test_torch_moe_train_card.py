"""MoE training on the card (ROADMAP A10 item 6): `chip_smoke.py`'s
card-against-CPU training check of qwen3-moe-30b-a3b (2 layers, 128
experts of 768, top-8, full remat; the loss, the aux loss, each layer's
routing in the forward and in the recompute, the dropped pairs, every
gradient with the stacked expert leaves compared on the experts routed
alike, one AdamW step's updates; the whole step, and stage by stage on the
CPU's recorded stages; MOE_TRAIN_CHECK and TRAIN_CHECK in float32 and
bf16) at a small width. The card test is marked `cuda` and
skips without a GPU; the others run the check's machinery on the CPU
(both sides there) and its pieces on hand-made routings. None imports
jax or the reference (the CPU parity with the reference is
tests/test_torch_moe.py's)."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402


#: the CPU check's config: 16 experts of 768 at top-8 over a 1,024-token
#: vocabulary, d_model 64
SMALL = {"d_model": 64, "vocab_size": 1024, "n_experts": 16}


@pytest.fixture
def cuda():
    """The card, or skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_moe_train_check_card_against_cpu(cuda):
    out = chip_smoke.check_moe_train_card_vs_cpu(cuda, {"d_model": 256})
    for dtype, forms in out.items():
        r = forms["staged"]
        assert r["finite"] and r["sel_set_agreement"] >= chip_smoke.MOE_TRAIN_CHECK["sel_set"], dtype
        assert all(all(layer["remat_routes_alike"].values()) for layer in r["layers"]), dtype


def test_moe_train_check_machinery_on_the_cpu():
    """Both sides on the CPU: the same numbers, the whole step's and the
    staged step's (its gradients are the whole step's, bit for bit), the
    routing recorded twice per layer (forward and recompute), nothing
    left out."""
    out = chip_smoke.check_moe_train_card_vs_cpu(torch.device("cpu"), SMALL)
    assert set(out) == {"float32", "bfloat16"}
    for r in (r for forms in out.values() for r in forms.values()):
        assert r["loss_rel"] == r["aux_rel"] == r["grad_rel_max"] == r["update_rel_max"] == 0.0
        assert r["sel_agreement"] == r["sel_set_agreement"] == 1.0 and r["aux_card"] > 0
        assert [layer["experts_left_out"] for layer in r["layers"]] == [0, 0]
        assert all(layer["remat_routes_alike"] == {"card": True, "cpu": True} for layer in r["layers"])
        assert r["pairs_per_layer"] == 2 * 128 * 8 and r["capacity"] == 160


def test_expert_table_places_each_kept_pair():
    """Tokens 0-2 at top-2 over 4 experts, capacity 1: the first pair of
    each expert is kept in slot 0, later ones dropped."""
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").model, n_experts=4, n_experts_per_token=2)
    sel = torch.tensor([[0, 1], [1, 2], [0, 3]])
    table, dropped = chip_smoke.expert_table(sel, cfg, cap=1)
    assert table.tolist() == [[0], [0], [1], [2]]
    assert dropped == 2


def test_a_flip_leaves_only_its_experts_out():
    """One token routed to expert 3 instead of 2 on one side: experts 2
    and 3 differ, the others agree."""
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").model, n_experts=4, n_experts_per_token=2)
    a = torch.tensor([[0, 1], [1, 2], [0, 3]])
    b = torch.tensor([[0, 1], [1, 3], [0, 2]])
    (ta, _), (tb, _) = chip_smoke.expert_table(a, cfg, 4), chip_smoke.expert_table(b, cfg, 4)
    assert (ta == tb).all(dim=1).tolist() == [True, True, False, False]


@pytest.mark.parametrize("names,want", [
    (["autograd::engine::evaluate_function: BmmBackward0", "BmmBackward0", "aten::bmm"], "aten::bmm"),
    (["aten::matmul", "aten::bmm"], "aten::matmul"),
    (["autograd::engine::evaluate_function: IndexBackward0", "IndexBackward0", "aten::index_put_",
      "aten::_index_put_impl_"], "aten::index_put_"),
    (["Optimizer.step", "cudaLaunchKernel"], "cudaLaunchKernel"),
])
def test_op_label_names_the_launching_op(names, want):
    assert chip_smoke.op_label(names) == want
