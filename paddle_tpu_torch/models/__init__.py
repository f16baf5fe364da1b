"""Model builders: the transformer LM and ResNet."""
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
