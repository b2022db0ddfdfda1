"""The paper's 6c-2s-12c-2s CNN-ELM (Tables 4/5, extended MNIST)."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="cnn-elm-6c12c", family="cnn",
    cnn_channels=(6, 12), cnn_kernel=5, cnn_pool=2,
    image_size=28, image_channels=1, num_classes=10,
    elm_lambda=100.0,  # paper uses positive 1/lambda regulariser
    source="this paper, Table 4/5",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="cnn-elm-6c12c-reduced", cnn_channels=(2, 4))
