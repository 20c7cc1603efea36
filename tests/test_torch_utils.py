"""The port's ``utils/prng.py`` and ``utils/log.py`` against the JAX
package's: named keys and key streams with ``jax.random.key_data``'s bits,
and the logger's format."""
import logging

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.utils import log as jlog  # noqa: E402
from repro.utils import prng as jprng  # noqa: E402
from repro_torch.data.synthetic import key  # noqa: E402
from repro_torch.utils import fold_in_name, get_logger, key_iter  # noqa: E402


def _bits(k):
    return np.stack([np.asarray(k[0], np.uint32), np.asarray(k[1], np.uint32)], -1)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
@pytest.mark.parametrize("name", ["stem", "seg0/rep3/b1", "", "ünïcode"])
def test_fold_in_name_bits_equal_jax(seed, name):
    ours = fold_in_name(key(seed), name)
    theirs = jax.random.key_data(jprng.fold_in_name(jax.random.key(seed), name))
    np.testing.assert_array_equal(_bits(ours), np.asarray(theirs))


@pytest.mark.parametrize("seed", [0, 7])
def test_key_iter_bits_equal_jax(seed):
    ours, theirs = key_iter(key(seed)), jprng.key_iter(jax.random.key(seed))
    for _ in range(6):
        np.testing.assert_array_equal(_bits(next(ours)), np.asarray(jax.random.key_data(next(theirs))))


def test_vision_init_takes_the_named_keys_from_prng():
    from repro_torch.models import vision
    from repro_torch.utils import prng

    assert vision.fold_in_name is prng.fold_in_name


def test_logger_format_equals_jax():
    ours, theirs = get_logger("dryrun"), jlog.get_logger("dryrun")
    assert ours.name == "repro_torch.dryrun" and theirs.name == "repro.dryrun"
    fmt = lambda lg: [h.formatter._fmt for h in logging.getLogger(lg.name.split(".")[0]).handlers]  # noqa: E731
    assert fmt(ours) == fmt(theirs) == ["%(asctime)s %(name)s %(levelname)s %(message)s"]
    assert logging.getLogger("repro_torch").level == logging.INFO
