"""Layer functions: build ops into the current Program."""
from . import io
from .io import *          # noqa: F401,F403
from . import nn
from .nn import *          # noqa: F401,F403
from . import nn_extra
from .nn_extra import *    # noqa: F401,F403
from . import tensor
from .tensor import *      # noqa: F401,F403
