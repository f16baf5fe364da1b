"""Model builders: the transformer LM, ResNet, the image models of the
book chapters and benchmark tables (mnist, vgg, alexnet, googlenet) and
the stacked LSTM."""
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
from . import mnist  # noqa: F401
from . import vgg  # noqa: F401
from . import alexnet  # noqa: F401
from . import googlenet  # noqa: F401
from . import stacked_lstm  # noqa: F401
