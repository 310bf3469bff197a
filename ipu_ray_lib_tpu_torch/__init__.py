"""ipu_ray_lib_tpu_torch: the PyTorch + CUDA port of ``ipu_ray_lib_tpu``.

The JAX package beside it is the reference; this package reproduces its
main path — the Cornell-box path trace that ``bench.py`` runs — on an
NVIDIA H100:

    scene.builtin.make_cornell_box_scene -> scene.build.build_scene
        -> render.streaming.render_streaming
        -> ops.megakernel.megakernel_path_trace
        -> ops/cuda/megakernel.cu (hand-written sm_90a kernel)

Host code is numpy and PyTorch and never imports jax. Every function
that touches tensors takes its device from its inputs or from an explicit
``device`` argument; nothing here holds global device state. CPU tensors
run the plain PyTorch version of each kernel (the tests' path); CUDA
tensors run the kernel.
"""

__version__ = "0.1.0"
