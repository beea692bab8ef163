"""``flash_attention``'s three kernels and how a call picks one.

On the CPU:

* ``_variant`` sends bf16 views with dh % 8 == 0, 64 < dh <= 128, 16-byte
  aligned bases and 16-byte multiple strides (danube's transposed (B, S, H,
  120) views, contiguous heads) to ``flash_wgmma_kernel``, the other bf16
  shapes (dh 8, 16, 20, 64, a misaligned base or stride, an odd head stride)
  to ``flash_bf16_kernel`` (mma.sync), and f32 to ``flash_f32_kernel``;
* ``wgmma_work``, the Python mirror of the wgmma kernel's plan (query tiles
  of 128 by KV tiles of 128, heaviest first, a "needs a mask" flag per
  consumer warpgroup), against a brute-force mask at S in {1, 127, 128, 129,
  300, 4097} and windows in {None, 1, 127, 128, 129, 4096}: every kept
  (query, key) pair lies in exactly one scheduled tile, every skipped tile is
  fully masked, every unflagged tile is fully kept;
* the tiles and kernel names agree with ``csrc/flash_attention.cu``.

On the card (``cuda`` marker, skipped elsewhere; no JAX import, so
``python -m pytest -m cuda tests/test_torch_flash.py`` runs on a machine
without it): the wgmma kernel against ``flash_attention_plain`` under
``testing.attention_error`` at those S and window edges, GQA groups 1, 4 and
8, dh 72, 120 and 128, strided and contiguous views, B 2; and the entry
point refusing a variant whose requirements fail.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.testing import attention_abs_mix, attention_error

# the kernel's module (the package attribute of that name is the wrapper)
fam = importlib.import_module("repro_torch.kernels.flash_attention")
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
EDGE_S = (1, 127, 128, 129, 300, 4097)
EDGE_WINDOWS = (None, 1, 127, 128, 129, 4096)


def _view(b, s, heads, dh, dtype=torch.bfloat16, strided=True, device="cpu",
          gen=None):
    """(B, heads, S, dh): a transposed (B, S, heads, dh) tensor (the
    transformer's layout) or a contiguous one."""
    shape = (b, s, heads, dh) if strided else (b, heads, s, dh)
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    return x.transpose(1, 2) if strided else x


# ---------------------------------------------------------------------------
# CPU: which kernel a call takes.
# ---------------------------------------------------------------------------


def test_variant_picks_wgmma_for_danube_views():
    q, k = _view(4, 300, 32, 120), _view(4, 300, 8, 120)
    assert fam._variant(q, k, k) == 2
    assert fam.VARIANTS[2] == "flash_wgmma_kernel"


@pytest.mark.parametrize("dh", [72, 80, 96, 104, 112, 120, 128])
def test_variant_picks_wgmma_for_contiguous_heads(dh):
    q, k = _view(2, 129, 8, dh, strided=False), _view(2, 129, 2, dh,
                                                      strided=False)
    assert fam._variant(q, k, k) == 2


@pytest.mark.parametrize("dh", [8, 16, 20, 64])
def test_variant_keeps_mma_sync_for_narrow_heads(dh):
    for strided in (True, False):
        q = _view(2, 77, 8, dh, strided=strided)
        k = _view(2, 77, 2, dh, strided=strided)
        assert fam._variant(q, k, k) == 1


def test_variant_keeps_mma_sync_for_misaligned_views():
    # a base 2 bytes off 16-byte alignment
    buf = torch.zeros(1 + 2 * 8 * 300 * 120, dtype=torch.bfloat16)
    q = buf[1:].view(2, 300, 8, 120).transpose(1, 2)
    k = _view(2, 300, 8, 120)
    assert fam._variant(q, k, k) == 1
    assert fam._variant(k, q, k) == 1 and fam._variant(k, k, q) == 1
    # an S stride that is not a multiple of 16 bytes: heads padded by 4
    pad = torch.zeros(2, 300, 8 * 120 + 4, dtype=torch.bfloat16)
    q = pad[:, :, :8 * 120].view(2, 300, 8, 120).transpose(1, 2)
    assert q.stride(2) % 8 != 0 and fam._variant(q, k, k) == 1
    # dh 120 with an odd head stride (121)
    odd = torch.zeros(2, 300, 8, 121, dtype=torch.bfloat16)[..., :120]
    q = odd.transpose(1, 2)
    assert fam._variant(q, k, k) == 1


def test_variant_keeps_simt_for_f32():
    q, k = _view(2, 300, 8, 120, torch.float32), _view(2, 300, 2, 120,
                                                       torch.float32)
    assert fam._variant(q, k, k) == 0


def test_variant_ignores_strides_of_length_one_axes():
    """B = 1 and a single head: those axes' strides never reach the map."""
    x = torch.zeros(1, 300, 1, 120, dtype=torch.bfloat16)
    q = x.as_strided((1, 1, 300, 120), (3, 5, 120, 1))
    assert fam._variant(q, q, q) == 2


# ---------------------------------------------------------------------------
# CPU: the wgmma kernel's work list against a brute-force mask.
# ---------------------------------------------------------------------------


def _kept(s, causal, window):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    keep = np.ones((s, s), dtype=bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= (i - j) < window
    return keep


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", EDGE_WINDOWS)
@pytest.mark.parametrize("s", EDGE_S)
def test_wgmma_work_covers_the_mask(s, window, causal):
    tq, tk, rows = fam.WG_TILE_Q, fam.WG_TILE_K, fam.WG_ROWS
    keep = _kept(s, causal, window)
    work = fam.wgmma_work(s, causal, window)
    covered = np.zeros((s, s), dtype=np.int32)
    assert sorted(q0 for q0, *_ in work) == list(range(0, s, tq))
    for q0, t0, t1, full in work:
        r = slice(q0, min(q0 + tq, s))
        assert 0 <= t0 < t1 <= -(-s // tk)
        covered[r, t0 * tk:t1 * tk] += 1
        # the tiles the kernel never loads are fully masked
        assert not keep[r, :t0 * tk].any() and not keep[r, t1 * tk:].any()
        assert len(full) == tq // rows
        for w, flags in enumerate(full):
            assert len(flags) == t1 - t0
            rw = slice(min(q0 + rows * w, s), min(q0 + rows * (w + 1), s))
            for i, unmasked in enumerate(flags):
                k0 = (t0 + i) * tk
                if unmasked:      # no mask: every pair of the tile is kept
                    assert k0 + tk <= s and keep[rw, k0:k0 + tk].all()
    assert (covered[keep] == 1).all()
    # heaviest first: KV tiles per query tile never grow along the order
    sizes = [t1 - t0 for _, t0, t1, _ in work]
    assert sizes == sorted(sizes, reverse=True)


def test_wgmma_work_at_the_lm_shape():
    """danube's prefill: 64 query tiles, the last first; 33 KV tiles a
    query tile once the window is full, two of them masked (the window's
    edge and the diagonal) for each consumer."""
    work = fam.wgmma_work(8192, True, 4096)
    assert [q0 for q0, *_ in work] == list(range(8192 - 128, -1, -128))
    q0, t0, t1, full = work[0]
    assert (t0, t1) == (31, 64)
    assert [flags.count(False) for flags in full] == [2, 2]
    assert sum(t1 - t0 for _, t0, t1, _ in work) == sum(
        min(qt, 32) + 1 for qt in range(64))


# ---------------------------------------------------------------------------
# CPU: the wrapper's constants are the kernel's.
# ---------------------------------------------------------------------------


def test_tiles_and_names_match_the_kernel_source():
    src = (CSRC / "flash_attention.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, f"{name} not found in flash_attention.cu"
        return int(m.group(1))

    assert (fam.WG_TILE_Q, fam.WG_TILE_K) == (const("FW_Q"), const("FW_K"))
    assert const("FW_ENCODE_ERROR") == fam.ENCODE_ERROR
    for name in fam.VARIANTS:
        assert re.search(rf"\b{name}\(", src), name


# ---------------------------------------------------------------------------
# The card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _check_wgmma(cuda, b, h, kv, s, dh, window, causal, strided, seed=0):
    from repro_torch import kernels as K
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = _view(b, s, h, dh, strided=strided, device=cuda, gen=gen)
    k = _view(b, s, kv, dh, strided=strided, device=cuda, gen=gen)
    v = _view(b, s, kv, dh, strided=strided, device=cuda, gen=gen)
    assert fam._variant(q, k, v) == 2
    before = K.flash_attention.launches
    got = K.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 1
    want = K.flash_attention_plain(q, k, v, causal=causal, window=window)
    err, used = attention_error(got, want,
                                attention_abs_mix(q, k, v, causal, window))
    assert used <= 1, (err, used)


@pytest.mark.cuda
@pytest.mark.parametrize("window", EDGE_WINDOWS)
@pytest.mark.parametrize("s", EDGE_S)
def test_cuda_wgmma_at_tile_and_window_edges(cuda, s, window):
    _check_wgmma(cuda, 2, 8, 2, s, 120, window, True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("dh", [72, 120, 128])
def test_cuda_wgmma_groups_heads_and_layouts(cuda, dh, group, strided):
    _check_wgmma(cuda, 2, 8, 8 // group, 300, dh, 129, True, strided)


@pytest.mark.cuda
@pytest.mark.parametrize("s,window", [(129, None), (300, 128), (4097, 4096)])
def test_cuda_wgmma_not_causal(cuda, s, window):
    _check_wgmma(cuda, 2, 8, 2, s, 128, window, False, False)


@pytest.mark.cuda
def test_cuda_entry_point_refuses_a_variant_it_cannot_run(cuda):
    """Variant 2 on a shape it does not take, and a variant of the other
    type, are refused with an error: no silent switch, no fallback."""
    from repro_torch import kernels as K
    lib = K.load_library("flash_attention", fam._bind)

    def run(variant, q):
        fam._launch(lib, variant, q, q, q, torch.empty_like(q), True, None)

    narrow = _view(1, 64, 4, 64, strided=False, device=cuda)
    odd = torch.zeros(1, 64, 4, 121, dtype=torch.bfloat16,
                      device=cuda)[..., :120].transpose(1, 2)
    f32 = _view(1, 64, 4, 120, torch.float32, strided=False, device=cuda)
    wide = _view(1, 64, 4, 120, strided=False, device=cuda)
    for variant, q in ((2, narrow), (2, odd), (2, f32), (1, f32),
                       (0, wide)):
        with pytest.raises(RuntimeError, match="launch failed"):
            run(variant, q)
    run(2, wide)
    run(1, wide)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wgmma_profile_parts(cuda):
    """The profiled instantiation computes the same output path and sums
    every part's cycles; its parts add up to the whole consumer."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _view(2, 1000, 8, 120, device=cuda, gen=gen)
    k = _view(2, 1000, 2, 120, device=cuda, gen=gen)
    prof = fam.wgmma_profile(q, k, k, True, 300)
    assert set(prof) == set(fam.PROFILE_PARTS)
    parts = sum(prof[p] for p in fam.PROFILE_PARTS[1:])
    assert prof["kernel"] > 0 and parts == prof["kernel"]
