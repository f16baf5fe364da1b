"""Unique name generator (reference python/paddle/fluid/unique_name.py)."""
from __future__ import annotations

import collections
import contextlib

__all__ = ['generate', 'switch', 'guard']


class UniqueNameGenerator(object):
    def __init__(self, prefix=''):
        self.ids = collections.defaultdict(int)
        self.prefix = prefix

    def __call__(self, key):
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + '_'.join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
