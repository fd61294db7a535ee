"""The yardstick's frozen copies against the port's work functions at the
cells' shapes, and the MoE family's FLOP count against a hand-worked
figure."""

import json
import sys

import pytest
import tiny_copy

ROOT, BENCH = tiny_copy.ROOT, tiny_copy.BENCH
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import harness  # noqa: E402
import yardstick as Y  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as SS  # noqa: E402

# (b, sq, skv, h, kv, d, causal): olmoe.train at B 2 and 4 and its
# global batch, olmoe.prefill, and zamba2-7b's shared block (d 112) in
# training (3 x 512) and prefill (8 x 1,024)
FLASH = [(4, 512, 512, 16, 16, 128, True), (2, 512, 512, 16, 16, 128, True),
         (8, 512, 512, 16, 16, 128, True), (8, 1024, 1024, 16, 16, 128, True),
         (3, 512, 512, 32, 32, 112, True), (8, 1024, 1024, 32, 32, 112, True)]
# (bs, s, h, g, p, n): zamba2-7b's Mamba-2 blocks in training and prefill
SSD = [(3, 512, 112, 1, 64, 64), (8, 1024, 112, 1, 64, 64)]


@pytest.mark.parametrize("shape", FLASH)
def test_flash_work_is_the_ports(shape):
    assert Y.flash_attention_work(*shape) == FA.flash_attention_work(*shape)
    assert (Y.flash_attention_grad_work(*shape)
            == FA.flash_attention_grad_work(*shape))


@pytest.mark.parametrize("shape", SSD)
def test_ssd_work_is_the_ports(shape):
    assert Y.ssd_scan_work(*shape) == SS.ssd_scan_work(*shape)
    assert Y.ssd_scan_grad_work(*shape) == SS.ssd_scan_grad_work(*shape)


MOE = harness.load_module(BENCH / "models" / "moe_lm.py")


def test_the_train_step_flops_of_olmoe_at_depth_4_by_hand():
    conf = json.loads((BENCH / "configs/olmoe-1b-7b.depth4.json").read_text())
    # a layer: q, k, v, o 4 x 2,048^2 = 16,777,216; router 2,048 x 64 =
    # 131,072; 8 experts x 3 x 2,048 x 1,024 = 50,331,648: 67,239,936.
    # Four layers 268,959,744 and the head 2,048 x 50,304 = 103,022,592:
    # 371,982,336 a token; 6 x that x 8 x 512 tokens = 9,141,837,889,536.
    # Attention: 4 x 8 rows x 16 heads x 128 x (512 x 513 / 2) pairs =
    # 8,606,711,808 a layer, x 4 layers x 3 (forward and backward) =
    # 103,280,541,696.  In all 9,245,118,431,232.
    assert MOE.train_step_flops(conf, 8, 512) == 9_245_118_431_232


def test_the_prefill_flops_of_olmoe_by_hand():
    conf = json.loads((BENCH / "configs/olmoe-1b-7b.json").read_text())
    # 2 x 67,239,936 x 16 layers x 8,192 tokens = 17,626,545,782,784; the
    # head at 8 last positions 2 x 103,022,592 x 8 = 1,648,361,472;
    # attention 4 x 8 x 16 x 128 x (1,024 x 1,025 / 2) x 16 layers =
    # 550,292,684,800.  In all 18,178,486,829,056.
    assert MOE.prefill_flops(conf, 8, 1024) == 18_178_486_829_056
