"""PyTorch/CUDA port of the ESPN retrieval stack.

A second package beside ``repro`` (the JAX reference). It imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro`` — and keeps its own
copy of every module it needs. The query path runs the ``espn`` backend
(two-phase IVF candidate generation, ANN-guided prefetch over the storage
tier, MaxSim rerank), the non-prefetching ``gds``/``mmap``/``swap``/``dram``
backends, and the ``bitvec``/``fde``/``cascade`` backends over resident
sign-bit and FDE tables, on four hand-written CUDA kernels:
``kernels/maxsim``, ``kernels/ivf_scan``, ``kernels/bitsim`` and
``kernels/fdescan``.

    from repro_torch.pipeline import Pipeline, PipelineConfig

    with Pipeline.build(PipelineConfig()) as pipe:     # device="cuda"
        print(pipe.evaluate())
"""
