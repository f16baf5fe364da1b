"""Built-in datasets (counterpart of paddle_tpu/dataset/). Nothing is
downloaded: each module serves deterministic synthetic data with the
sample format, dtypes, vocab objects and reader-creator API of the
original, the same samples as the JAX package's module (common.py's
synthetic_rng). `dataset.image` (imported by name, as in the JAX
package) holds the host-side image transforms; its decode and resize
import Pillow when called."""
from . import common  # noqa: F401
from . import uci_housing  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05  # noqa: F401
from . import sentiment  # noqa: F401
from . import wmt14  # noqa: F401
from . import wmt16  # noqa: F401
from . import flowers  # noqa: F401
from . import voc2012  # noqa: F401
from . import mq2007  # noqa: F401
from . import uci_housing as housing  # noqa: F401

__all__ = ['common', 'uci_housing', 'mnist', 'cifar', 'imdb', 'imikolov',
           'movielens', 'conll05', 'sentiment', 'wmt14', 'wmt16', 'flowers',
           'voc2012', 'mq2007']
