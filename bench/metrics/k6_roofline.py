"""k6_roofline: K6 ``flash_attention`` (``kernels/csrc/flash_attention.cu``)
over the window: the sum of its calls' bounds (``roofline.k6_bound_s``, one
call a layer of each execution of n prompts) ÷ the device time of its
kernels in the trace."""
from bench import roofline
from bench.trace import K6_KERNEL


def read(t):
    dev = t.kernel_s(K6_KERNEL)
    if dev <= 0 or not t.spans.exec_sizes:
        return None
    m = t.config
    s = m["deployment"]["prompt_tokens"]
    need = sum(m["num_hidden_layers"] * roofline.k6_bound_s(
        n, s, m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"])
        for n in t.spans.exec_sizes)
    return 100.0 * need / dev
