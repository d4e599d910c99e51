"""The host-side launch plan of K6 ``decode_attn``, on the CPU: how many
pieces it cuts a (sequence, kv head) into, and its stage tile.  The
kernel itself runs in ``test_torch_cuda.py`` on the card."""

import pytest
import torch

from repro_torch.kernels.decode_attn import kernel as DAK


@pytest.mark.parametrize("bh,S,want", [
    (64, 32768, 9),      # decode_32k at B 32, Hkv 2: 576 blocks >= 528
    (64, 8192, 9),       # the serving shape
    (32, 32768, 17),     # gemma3's one kv head
    (1, 32768, 64),      # one sequence: the cap
    (8, 300, 5),         # no more pieces than 64-row tiles
    (4096, 32768, 1),    # a batch that fills the card alone
    (1, 1, 1),
])
def test_split_count_cases(bh, S, want):
    assert DAK.split_count(bh, S, 132) == want


def test_split_count_covers_two_waves_unless_capped():
    for bh in range(1, 600, 7):
        for S in (1, 63, 64, 65, 300, 4096, 32768):
            n = DAK.split_count(bh, S, 132)
            assert 1 <= n <= DAK.MAX_SPLIT
            capped = n in (DAK.MAX_SPLIT, -(-S // 64))
            assert bh * n >= 2 * DAK.BLOCKS_PER_SM * 132 or capped
            # the smallest such count: one fewer piece falls short
            assert n == 1 or bh * (n - 1) < 2 * DAK.BLOCKS_PER_SM * 132


@pytest.mark.parametrize("D,dtype,want", [
    (16, torch.bfloat16, 128), (64, torch.bfloat16, 128),
    (128, torch.bfloat16, 64), (256, torch.bfloat16, 32),
    (16, torch.float32, 128), (64, torch.float32, 64),
    (128, torch.float32, 32), (256, torch.float32, 16),
])
def test_tile_rows(D, dtype, want):
    assert DAK.tile_rows(D, dtype) == want
    assert want * D * torch.finfo(dtype).bits // 8 <= 16384
