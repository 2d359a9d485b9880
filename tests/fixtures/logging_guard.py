"""A module-scoped fixture for test files that call the JAX package's code.

The JAX package's `init_logger` adds a run's log file only to a logger that
has no handler yet, and its `get_logger` gives the logger one: a test that
calls into the JAX package (a CLI, `MessageLogger`, an entry point's
logging) leaves the 'videoswap_tpu' logger set up for the rest of its
process, and a later JAX CLI test in the same process (for example
tests/test_checkpointing.py's, which reads its run's log file) then finds
no log file. Imported into a test module, the fixture puts the logger's
handlers and level back as they were when the module started.
"""

import logging

import pytest


@pytest.fixture(scope='module', autouse=True)
def jax_logger_as_found():
    logger = logging.getLogger('videoswap_tpu')
    handlers, level = list(logger.handlers), logger.level
    yield
    for h in logger.handlers[:]:
        if h not in handlers:
            logger.removeHandler(h)
            h.close()
    logger.setLevel(level)
