"""Layer functions: build ops into the current Program."""
from . import io
from .io import *          # noqa: F401,F403
from . import nn
from .nn import *          # noqa: F401,F403
from . import nn_extra
from .nn_extra import *    # noqa: F401,F403
from . import tensor
from .tensor import *      # noqa: F401,F403
from . import ops
from .ops import *         # noqa: F401,F403
from . import math_op_patch  # noqa: F401  (side effect: Variable operators)
from . import control_flow
from .control_flow import *  # noqa: F401,F403
from . import learning_rate_scheduler
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import sequence
from .sequence import *    # noqa: F401,F403
from . import detection
from .detection import *   # noqa: F401,F403

__all__ = (io.__all__ + nn.__all__ + nn_extra.__all__ + tensor.__all__
           + ops.__all__ + control_flow.__all__
           + learning_rate_scheduler.__all__ + sequence.__all__
           + detection.__all__)
