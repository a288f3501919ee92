"""The port's program analyzer (`launch/hlo_analysis.py: analyze_program`)
on known programs, case by case as `tests/test_hlo_analysis.py` holds the
reference's HLO analyzer: trip counts (Python loops run), batched
products, bytes scaling with trip count, slice writes counted at the
update, collectives by group size, roofline terms and dominance (against
`H100_SXM`); and the port's own: B10's meta form by both attention rules,
and one slot of a group program counted alone."""
import pytest
import torch

from repro_torch import compat
from repro_torch.core.energy import H100_SXM
from repro_torch.kernels import flash_attn, ops
from repro_torch.launch.hlo_analysis import CollectiveStats, Cost, analyze_program, roofline
from repro_torch.models import partition
from repro_torch.runtime.elastic import make_mesh

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

META = torch.device("meta")


def test_loop_trip_count_scaling():
    a = torch.ones(64, 64)

    def looped(x):
        for _ in range(7):
            x = x @ a
        return x

    cost, _ = analyze_program(looped, torch.ones(64, 64))
    assert cost.flops == 7 * 2 * 64 ** 3


def test_nested_loop_trip_counts_multiply():
    a = torch.empty(32, 32, device=META)

    def nested(x):
        for _ in range(3):
            for _ in range(4):
                x = x @ a
        return x

    cost, _ = analyze_program(nested, torch.empty(32, 32, device=META))
    assert cost.flops == 12 * 2 * 32 ** 3


def test_batched_dot_flops():
    cost, _ = analyze_program(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                              torch.ones(4, 16, 32), torch.ones(4, 32, 8))
    assert cost.flops == 2 * 4 * 16 * 32 * 8


def test_bytes_scale_with_trip_count():
    def f(x):
        for _ in range(50):
            x = torch.tanh(x) * 2.0
        return x

    c1, _ = analyze_program(f, torch.ones(256, 256))
    c2, _ = analyze_program(lambda x: torch.tanh(x) * 2.0, torch.ones(256, 256))
    assert c1.bytes > 20 * c2.bytes
    assert c1.transcendentals == 50 * 256 * 256


def test_slice_write_counted_as_slice_not_buffer():
    """A loop writing one row of a big stacked buffer per trip must not
    charge the whole buffer per trip."""

    def f(x):
        buf = torch.zeros((100,) + tuple(x.shape))
        for i in range(100):
            buf[i] = x * 1.0
        return buf

    cost, _ = analyze_program(f, torch.ones(64, 64))
    slice_bytes = 64 * 64 * 4
    assert cost.bytes < 100 * slice_bytes * 20
    assert cost.bytes >= 100 * slice_bytes


def test_collectives_counted_with_group_size():
    p = torch.ones(16, 1024)

    def f():
        compat.all_gather([p] * 4, [torch.device("cpu")] * 4, dim=0)
        compat.psum([p] * 4, [torch.device("cpu")] * 4)

    _, coll = analyze_program(f)
    ag, ar = coll.per_op["all-gather"], coll.per_op["all-reduce"]
    assert ag["operand_bytes"] == 64 * 1024 * 4 / 4  # output / n
    assert ar["operand_bytes"] == 16 * 1024 * 4
    assert ar["wire_bytes"] == 2 * 3 / 4 * 16 * 1024 * 4
    assert ag["count"] == ar["count"] == 1


def test_roofline_terms_and_dominance():
    cost = Cost(flops=H100_SXM.peak_flops, bytes=H100_SXM.hbm_bw * 2)  # 1 s compute, 2 s memory
    t = roofline(cost, CollectiveStats({}), chips=4)
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 2.0) < 1e-9
    assert t.dominant == "memory"
    assert t.flops_global == H100_SXM.peak_flops * 4
    coll = CollectiveStats({"all-reduce": {"count": 1.0, "operand_bytes": H100_SXM.link_bw * 3,
                                           "wire_bytes": 0.0}})
    assert roofline(cost, coll, chips=4).dominant == "collective"


@pytest.mark.parametrize("name", ["flash_attention_fwd", "flash_attention_fwd_tc", "flash_attention_fwd_lse",
                                  "flash_attention_fwd_lse_fma"])
def test_b10_meta_form_reports_its_work_and_launches_nothing(name):
    b, s, h, kh, dh = 2, 256, 8, 2, 64
    q = torch.empty(b, s, h, dh, dtype=torch.bfloat16, device=META)
    k = torch.empty(b, s, kh, dh, dtype=torch.bfloat16, device=META)
    ops.reset_launches()
    for rule, want in (("pairs", flash_attn.flops(b, s, s, h, dh, None, True)), ("blocks", 4 * b * h * dh * s * s)):
        got = []
        cost, _ = analyze_program(lambda: got.append(getattr(ops, name)(q, k, k)), attention=rule)
        out = got[0][0] if isinstance(got[0], tuple) else got[0]
        assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "meta"
        assert cost.flops == want
    assert not any(ops.launch_counts().values())


def test_b10_refuses_other_devices_and_meta_stays_off_the_other_kernels():
    with pytest.raises(ValueError, match="unsupported device"):
        ops.pack_blocks(torch.empty(64, 2, dtype=torch.int32, device=META),
                        torch.empty(64, dtype=torch.int32, device=META), 64)


def test_one_slot_of_a_group_program_is_counted():
    """Each slot's product counted once for its slot, the backward's with
    the forward's slot; the psum's arithmetic in the collective alone."""
    mesh = make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    w = [torch.randn(8, 8, requires_grad=True) for _ in range(4)]
    with partition.logical_axes({"data": "data", "model": "model"}), partition.set_mesh(mesh):
        g = partition.model_groups(mesh, {})[0]

        def run():
            parts = g.map(lambda i, wi: torch.ones(2, 8) @ wi, w)
            with compat.slots_of(g.slots):
                total = compat.psum(parts, g.devices)
            torch.autograd.grad(total[0].sum(), w)

        for slot in (0, 3):
            cost, coll = analyze_program(run, slot=slot)
            assert cost.flops == 2 * 2 * 8 * 8 + 2 * 8 * 2 * 8  # forward, and the weight's gradient
            assert coll.per_op["all-reduce"]["count"] == 1
