"""The port's fused query path against the reference's ``RefStore`` model.

The op interleavings of tests/test_torch_store_properties.py with every
``query_batch`` on the fused (reuse_top1) path, over the reference's 200
seeds (``2000 + s``, as tests/test_store_properties.py runs its fused
sweep).  A file of its own so that the two sweeps run on separate workers.
"""
import pytest
from test_torch_store_properties import run_interleaving


class TestPortStoreProperties:
    @pytest.mark.parametrize("seed", range(200))
    def test_interleaving_parity_fused(self, seed):
        run_interleaving(2000 + seed, fused=True)
