"""API annotations (counterpart of paddle_tpu/annotations.py)."""
from __future__ import annotations

import functools
import sys

__all__ = ['deprecated']


def deprecated(since, instead, extra_message=''):
    def decorator(func):
        err_msg = 'API {0} is deprecated since {1}. Please use {2} ' \
                  'instead.'.format(func.__name__, since, instead)
        if len(extra_message) != 0:
            err_msg += '\n' + extra_message

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            print(err_msg, file=sys.stderr)
            return func(*args, **kwargs)
        wrapper.__doc__ = (func.__doc__ or '') + '\n    ' + err_msg
        return wrapper
    return decorator
