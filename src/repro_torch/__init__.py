"""PyTorch/CUDA port of the ESPN retrieval stack.

A second package beside ``repro`` (the JAX reference). It imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro`` — and keeps its own
copy of every module it needs. The query path runs the ``espn`` backend
(two-phase IVF candidate generation, ANN-guided prefetch over the storage
tier, MaxSim rerank) and the non-prefetching ``gds``/``mmap``/``swap``/
``dram`` backends, on two hand-written CUDA kernels: ``kernels/maxsim`` and
``kernels/ivf_scan``.

    from repro_torch.pipeline import Pipeline, PipelineConfig

    with Pipeline.build(PipelineConfig()) as pipe:     # device="cuda"
        print(pipe.evaluate())
"""
