"""Op emitters; importing this package registers every op the port runs."""
from . import tensor_ops    # noqa: F401
from . import math_ops      # noqa: F401
from . import nn_ops        # noqa: F401
from . import attention_ops  # noqa: F401
from . import io_ops        # noqa: F401
from . import loss_ops      # noqa: F401
from . import fused_ops     # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import control_flow_ops  # noqa: F401
