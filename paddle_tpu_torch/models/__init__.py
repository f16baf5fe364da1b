"""Model builders: the transformer LM, ResNet, and the image models of
the book chapters and benchmark tables (mnist, vgg, alexnet,
googlenet)."""
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
from . import mnist  # noqa: F401
from . import vgg  # noqa: F401
from . import alexnet  # noqa: F401
from . import googlenet  # noqa: F401
