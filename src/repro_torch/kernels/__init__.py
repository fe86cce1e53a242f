"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

``csrc/`` holds the CUDA C++ sources (built by ``build.py``), ``ref.py`` the
plain PyTorch version of every kernel, ``sim_topk.py`` / ``lsh_hash.py`` the
wrappers that launch a kernel for a CUDA tensor and run the plain version for
a CPU tensor, and ``ops.py`` the padding and dispatch around them.
"""
