"""The port's ResNet-50 encoder against the JAX package's, on the CPU.

``tests/test_torch_resnet.py`` (a) at ResNet-50: the same flax weights and
formula canvases through both packages' encoders, vector and grid memory,
eval and train mode; layer4's map, the memory and the running buffers within
1e-4 of the largest magnitude in float32, except in train mode, where the
JAX package's own float32 result is ~6e-4 from its float64 one: there both
packages are held in float64 (1e-9), and the port's float32 no farther from
it than the JAX package's float32.
"""

import pytest
import torch

from test_torch_resnet import check_encoder, encoder_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def encoders():
    return encoder_pair("resnet50")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("memory", ["vector", "grid"])
def test_resnet50_encoder_matches_flax(encoders, memory, train):
    check_encoder(encoders, memory, train)
