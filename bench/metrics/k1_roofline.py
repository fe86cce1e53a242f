"""k1_roofline: K1 ``reuse_top1_probed`` (``kernels/csrc/reuse_probed.cu``)
over the window: the sum of each fused query's bound (``roofline.k1_bound_s``:
its queries and distinct (query, candidate) pairs, the store's own
``candidate_counts``; the distinct rows read are not counted, so the bound
is low, never high) ÷ the device time of its kernels in the trace."""
from bench import roofline
from bench.trace import K1_KERNEL


def read(t):
    dev = t.kernel_s(K1_KERNEL)
    if dev <= 0 or not t.spans.k1:
        return None
    lsh = t.config["deployment"]["lsh"]
    need = sum(roofline.k1_bound_s(b, lsh["dim"], lsh["num_tables"], lsh["num_probes"], pairs)
               for b, pairs in t.spans.k1)
    return 100.0 * need / dev
