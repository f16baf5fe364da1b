"""MovieLens-1M (counterpart of paddle_tpu/dataset/movielens.py): the
recommender book config. Samples: (user_id, gender_id, age_id, job_id,
movie_id, category_ids, title_ids, score), synthetic, with the original's
vocab sizes."""
from __future__ import annotations

from . import common

__all__ = ['train', 'test', 'max_user_id', 'max_movie_id', 'max_job_id',
           'age_table', 'movie_categories', 'get_movie_title_dict',
           'user_info', 'movie_info', 'convert']

_MAX_USER, _MAX_MOVIE, _MAX_JOB = 6040, 3952, 20
_N_CATEGORIES, _TITLE_VOCAB = 18, 1512
_N_TRAIN, _N_TEST = 4096, 512

age_table = [1, 18, 25, 35, 45, 50, 56]


def max_user_id():
    return _MAX_USER


def max_movie_id():
    return _MAX_MOVIE


def max_job_id():
    return _MAX_JOB


def movie_categories():
    return {('cat%02d' % i): i for i in range(_N_CATEGORIES)}


def get_movie_title_dict():
    return {('t%04d' % i): i for i in range(_TITLE_VOCAB)}


def _creator(split, n):
    def reader():
        rng = common.synthetic_rng('movielens', split)
        for _ in range(n):
            user_id = int(rng.randint(1, _MAX_USER + 1))
            gender_id = int(rng.randint(0, 2))
            age_id = int(rng.randint(0, len(age_table)))
            job_id = int(rng.randint(0, _MAX_JOB + 1))
            movie_id = int(rng.randint(1, _MAX_MOVIE + 1))
            n_cat = int(rng.randint(1, 4))
            categories = rng.randint(0, _N_CATEGORIES, n_cat)
            n_title = int(rng.randint(1, 6))
            title = rng.randint(0, _TITLE_VOCAB, n_title)
            # score correlates with (user+movie) parity so models can learn
            base = 1.0 + 4.0 * (((user_id + movie_id) % 97) / 96.0)
            score = float(min(5.0, max(1.0, base + 0.3 * rng.randn())))
            yield (user_id, gender_id, age_id, job_id, movie_id,
                   categories.astype('int64').tolist(),
                   title.astype('int64').tolist(), score)
    return reader


def train():
    return _creator('train', _N_TRAIN)


def test():
    return _creator('test', _N_TEST)


class MovieInfo(object):
    """A movie of the catalog."""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        cat_ids = movie_categories()
        title_ids = get_movie_title_dict()
        return [self.index,
                [cat_ids[c] for c in self.categories],
                [title_ids[w] for w in self.title.split()]]

    def __repr__(self):
        return '<MovieInfo id(%d), title(%s), categories(%s)>' % (
            self.index, self.title, self.categories)


class UserInfo(object):
    """A user of the catalog."""

    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == 'M'
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age,
                self.job_id]

    def __repr__(self):
        return '<UserInfo id(%d), gender(%s), age(%d), job(%d)>' % (
            self.index, 'M' if self.is_male else 'F',
            age_table[self.age], self.job_id)


def movie_info():
    """id -> MovieInfo for the synthetic catalog, the same on every
    call. Samples draw their category and title features from the
    per-split streams, not from this catalog (as in the JAX package), so
    joining samples to the catalog by movie_id gives independent
    features."""
    rng = common.synthetic_rng('movielens', 'catalog')
    cats = sorted(movie_categories())
    out = {}
    for mid in range(1, _MAX_MOVIE + 1):
        n_cat = int(rng.randint(1, 4))
        cat = [cats[int(c)]
               for c in rng.randint(0, _N_CATEGORIES, n_cat)]
        n_title = int(rng.randint(1, 6))
        title = ' '.join('t%04d' % t
                         for t in rng.randint(0, _TITLE_VOCAB, n_title))
        out[mid] = MovieInfo(mid, cat, title)
    return out


def user_info():
    """id -> UserInfo for the synthetic catalog."""
    rng = common.synthetic_rng('movielens', 'users')
    out = {}
    for uid in range(1, _MAX_USER + 1):
        gender = 'M' if int(rng.randint(0, 2)) else 'F'
        age = age_table[int(rng.randint(0, len(age_table)))]
        job = int(rng.randint(0, _MAX_JOB + 1))
        out[uid] = UserInfo(uid, gender, age, job)
    return out


def convert(path):
    """Write train/test to RecordIO shards under `path`."""
    common.convert(path, train(), 1000, 'movielens_train')
    common.convert(path, test(), 1000, 'movielens_test')
