"""Reservoir core of the port: LSH, naming, packets, Content Store, the
LSH-indexed reuse store and the TTC estimator.

Import from the modules (``repro_torch.core.reuse_store`` and so on); this
package file re-exports nothing, so importing one module does not pull in
the kernels through another.
"""
