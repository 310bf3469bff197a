"""The tests of tests/test_torch_megakernel.py on the bench scene (the
Cornell box with the monkey plinth), in a file of their own so that the
test workers run the two scenes side by side."""

import torch_threads  # noqa: F401  (first: one torch thread)
import pytest

import test_torch_megakernel as base
from test_torch_megakernel import (  # noqa: F401  (collected here too)
    cuda_device, test_cpu_tensors_launch_no_kernel,
    test_cuda_kernel_matches_plain, test_pixel_group_offset_matches_full_dispatch,
    test_plain_matches_jax_interpret, test_ref_entry_point_matches_dispatch,
    test_rejects_mismatched_stream)


@pytest.fixture(scope="module", params=["monkey"])
def case(request):
    return base.make_case(request.param)
