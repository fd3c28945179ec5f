"""The forms of the star-GAT forward kernels (`gat_kernels.fwd_form`) and
their workspaces: which form each shape and dtype takes, that the
per-slot fused form allocates no float32 projection P (bf16 and float32),
that the pooled valid-rows form stages the compacted rows with their
padding, how `use_form` forces a form, and how the wrappers count
launches by form. Nothing here launches a kernel: the forms themselves
are held against their plain versions on the card
(tests/test_torch_cuda.py, `-k "fused or valid_rows"`)."""
import pytest
import torch

from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_torch.ops.launch import train_args

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread, so that parallel test workers do
    not oversubscribe the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype,n,pooled,store,form", [
    (BF16, 64, False, False, "fused"),        # every configuration's K1
    (BF16, 64, False, True, "fused"),         # its store form
    (BF16, 16, False, False, "fused"),        # several egonets a tile
    (BF16, 65, False, False, "two_pass"),     # no whole egonet a tile
    (BF16, 64, True, False, "valid_rows"),    # K3 eval and train forms
    (BF16, 64, True, True, "two_pass"),       # K3's store form: all rows
    (F32, 64, False, False, "fused"),         # float32 K1, every form
    (F32, 64, True, False, "valid_rows"),     # float32 K3 eval and train
    (F32, 65, False, False, "two_pass"),      # no whole egonet a tile
    (F32, 64, True, True, "two_pass"),        # float32 K3's store form
])
def test_fwd_form_by_shape_and_dtype(dtype, n, pooled, store, form):
    x = torch.zeros((2, n, 8), dtype=dtype)
    assert gk.fwd_form(x, pooled, store) == form


def _work(form, b=3, n=64, din=250, heads=4, dh=500, pos=50, dtype=BF16):
    x = torch.zeros((b, n, din), dtype=dtype)
    pe = (torch.zeros(n, pos), torch.zeros(pos, heads * dh),
          torch.zeros(pos, heads), torch.zeros(pos, heads))
    ta = train_args(pe, 7, 0.1, 0.1)
    work = gk._fwd_work(x, heads, dh, 0.1, ta, form)
    shapes = {k: None if t is None else tuple(t.shape)
              for k, t in zip(gk._FWD_POINTERS, work.tensors)}
    return work.args, shapes


def test_fused_form_allocates_no_projection():
    """config.mag.json layer 0 (250 + pe 50 -> 4 x 500): no P [B*N, wdp];
    W split into [fc; wp] (2000 columns) and [wa1 | wa2; wpa1 | wpa2];
    pass A's a1 | a2 and the star weights per row and head."""
    args, shapes = _work("fused")
    m = 3 * 64
    assert shapes["proj"] is None
    assert shapes["wcat"] == (304, 2000) and args.wdp == 2000
    assert shapes["wa"] == (304, 8) and args.wap == 8
    assert shapes["a12"] == (m, 8) and args.lda == 8
    assert shapes["biasa"] == (64, 8) and shapes["biascat"] == (64, 2000)
    assert shapes["wts"] == (m, 4, 4)
    assert shapes["xm"] == (m, 304) and args.kxp == 304
    assert shapes["row_off"] is None and shapes["row_map"] is None


def test_f32_fused_form_allocates_no_projection():
    """The float32 twin (config.mag.json layer 0, 250 + pe 50 -> 4 x 500):
    no P; W as W^T's TF32 hi / lo planes, [fc; wp] (2000 rows of 300
    columns, 16-byte rows of 4 floats) and [wa1 | wa2; wpa1 | wpa2];
    pass A's a1 | a2 and the star weights float32, as in bf16."""
    args, shapes = _work("fused", dtype=F32)
    m = 3 * 64
    assert shapes["proj"] is None
    assert shapes["wcat"] == (2, 2000, 300) and args.wdp == 2000
    assert shapes["wa"] == (2, 8, 300) and args.wap == 8
    assert shapes["a12"] == (m, 8) and args.lda == 8
    assert shapes["biasa"] == (64, 8) and shapes["biascat"] == (64, 2000)
    assert shapes["wts"] == (m, 4, 4)
    assert shapes["xm"] == (m, 300) and args.kxp == 300
    assert shapes["row_off"] is None and shapes["row_map"] is None


def test_use_form_forces_a_form_that_serves_the_call():
    """Inside `use_form` every forward takes the named form where it can
    run the call, and raises where it cannot; outside, the shape's own."""
    x = torch.zeros((2, 64, 8))
    with gk.use_form("two_pass"):
        assert gk.fwd_form(x, False) == "two_pass"
        assert gk.fwd_form(x, True) == "two_pass"
        with gk.use_form("fused"):
            assert gk.fwd_form(x, False) == "fused"
            with pytest.raises(ValueError):
                gk.fwd_form(x, True)
        assert gk.fwd_form(x, False) == "two_pass"
    with gk.use_form("valid_rows"), pytest.raises(ValueError):
        gk.fwd_form(x, True, store=True)
    with pytest.raises(ValueError), gk.use_form("no_such_form"):
        pass
    assert gk.fwd_form(x, False) == "fused"
    assert gk.fwd_form(x, True) == "valid_rows"


def test_valid_rows_form_stages_compacted_rows():
    """The pooled final layer (2000 + pe 50 -> 1 x 500): X always staged,
    ROW_PAD zero rows after the valid ones, the row offsets and row map;
    P over the allocated rows (the valid rows fill its first R)."""
    args, shapes = _work("valid_rows", din=2000, heads=1)
    m = 3 * 64
    assert shapes["xm"] == (m + gk.ROW_PAD, 2056) and args.kxp == 2056
    assert shapes["proj"] == (m, 504) and args.wdp == 504
    assert shapes["row_off"] == (4,)
    assert shapes["row_map"] == (m + gk.ROW_PAD,)
    assert shapes["wa"] is None and shapes["a12"] is None


def test_two_pass_form_keeps_the_projection():
    args, shapes = _work("two_pass", b=2, n=70)
    assert shapes["proj"] == (140, 2008) and args.wdp == 2008
    assert shapes["wa"] is None and shapes["row_map"] is None


def test_forward_launches_counted_by_form():
    """A launch of either dtype counts under its form too; empty batches
    do not."""
    wrapper = gk.gat_layer_fwd_train
    saved = (wrapper.launches, wrapper.launches_bf16,
             dict(wrapper.launches_by_heads), dict(wrapper.launches_by_form))
    try:
        wrapper.launches_by_form = {}
        gk._count_fwd(wrapper, torch.zeros((2, 64, 8), dtype=BF16), 4,
                      "fused")
        gk._count_fwd(wrapper, torch.zeros((2, 64, 8), dtype=BF16), 4,
                      "fused")
        gk._count_fwd(wrapper, torch.zeros((2, 70, 8), dtype=BF16), 4,
                      "two_pass")
        gk._count_fwd(wrapper, torch.zeros((0, 64, 8), dtype=BF16), 4,
                      "fused")
        gk._count_fwd(wrapper, torch.zeros((2, 64, 8)), 4, "two_pass")
        gk._count_fwd(wrapper, torch.zeros((2, 64, 8)), 4, "fused")
        assert wrapper.launches_by_form == {"fused": 3, "two_pass": 2}
    finally:
        (wrapper.launches, wrapper.launches_bf16, wrapper.launches_by_heads,
         wrapper.launches_by_form) = saved
