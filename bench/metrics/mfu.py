"""mfu: the model FLOPs of every prefill executed in the window (counted
from shapes by ``roofline.prefill_flop``) ÷ (window × the H100's dense bf16
peak, 989 TFLOP/s at 700 W)."""
from bench import roofline


def read(t):
    if not t.spans.exec_sizes or t.window_s <= 0:
        return None
    s = t.config["deployment"]["prompt_tokens"]
    flop = sum(roofline.prefill_flop(t.config, n, s) for n in t.spans.exec_sizes)
    return 100.0 * flop / (t.window_s * roofline.BF16_FLOP_PER_S)
