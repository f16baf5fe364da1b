"""Thread-local default-scope stack (counterpart of
paddle_tpu/default_scope_funcs.py): a nested-scope discipline over
executor.Scope's new_scope and drop_kids."""
from __future__ import annotations

import threading

from .executor import Scope

__all__ = ['get_cur_scope', 'enter_local_scope', 'leave_local_scope',
           'var', 'find_var', 'has_var', 'scoped_function']

_tls = threading.local()


def get_cur_scope():
    stack = getattr(_tls, 'scope_stack', None)
    if not stack:
        _tls.scope_stack = [Scope()]
    return _tls.scope_stack[-1]


def enter_local_scope():
    cur = get_cur_scope()
    _tls.scope_stack.append(cur.new_scope())


def leave_local_scope():
    _tls.scope_stack.pop()
    get_cur_scope().drop_kids()


def var(name):
    """Create or find a variable in the current scope."""
    return get_cur_scope().var(name)


def find_var(name):
    """Value of the variable, searching parent scopes (None if the
    slot exists but holds no value yet — scope.has_var distinguishes)."""
    return get_cur_scope().find_var(name)


def has_var(name):
    return get_cur_scope().has_var(name)


def scoped_function(func):
    """Run func inside a fresh local scope, dropping it afterwards."""
    enter_local_scope()
    try:
        func()
    finally:
        leave_local_scope()
