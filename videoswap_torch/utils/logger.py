"""Experiment directories and logging (the port of
videoswap_tpu/utils/logger.py, single-process: the port has no
`parallel/`).

`set_path_logger` creates `experiments/<name>` (training) or
`results/<name>` (testing) under the root, archive-renames an existing one
with a timestamp, copies the config file there under a command-line header,
records the paths in `opt['path']` and starts the log file.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from datetime import datetime

LOGGER_NAME = 'videoswap_torch'


def get_time_str() -> str:
    return datetime.now().strftime('%Y%m%d_%H%M%S')


def mkdir_and_rename(path: str) -> None:
    """mkdir; when it exists, archive-rename the old one with a timestamp."""
    if os.path.exists(path):
        os.rename(path, path + '_archived_' + get_time_str())
    os.makedirs(path, exist_ok=True)


def copy_opt_file(opt_path: str, experiments_root: str) -> None:
    os.makedirs(experiments_root, exist_ok=True)
    with open(opt_path, 'r') as f:
        content = f.read()
    header = (f'# GENERATE TIME: {time.asctime()}\n'
              f'# CMD: {" ".join(sys.argv)}\n\n')
    with open(os.path.join(experiments_root, os.path.basename(opt_path)),
              'w') as f:
        f.write(header + content)


def set_path_logger(root_path: str, config_path: str, opt: dict,
                    is_train: bool = True) -> dict:
    """Create the experiment directory tree and record its paths in
    `opt['path']` (exp_root, models, visualization, log)."""
    name = opt['name']
    exp_root = os.path.join(root_path,
                            'experiments' if is_train else 'results', name)
    mkdir_and_rename(exp_root)
    paths = {
        'exp_root': exp_root,
        'models': os.path.join(exp_root, 'models'),
        'visualization': os.path.join(exp_root, 'visualization'),
        'log': os.path.join(exp_root, f'{"train" if is_train else "test"}_'
                            f'{name}_{get_time_str()}.log'),
    }
    for k in ('models', 'visualization'):
        os.makedirs(paths[k], exist_ok=True)
    copy_opt_file(config_path, exp_root)
    opt.setdefault('path', {}).update(paths)
    init_logger(paths['log'])
    return paths


def init_logger(log_file: str | None = None) -> logging.Logger:
    """The port's logger: a stream handler once, and a file handler for
    each new `log_file` (one run's log does not go on into the next's)."""
    logger = logging.getLogger(LOGGER_NAME)
    fmt = logging.Formatter('%(asctime)s %(levelname)s: %(message)s')
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file:
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        fh = logging.FileHandler(log_file, 'w')
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def get_logger() -> logging.Logger:
    return init_logger()


def dict2str(opt: dict, indent_level: int = 1) -> str:
    msg = '\n'
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += ' ' * (indent_level * 2) + k + ':['
            msg += dict2str(v, indent_level + 1)
            msg += ' ' * (indent_level * 2) + ']\n'
        else:
            msg += ' ' * (indent_level * 2) + k + ': ' + str(v) + '\n'
    return msg
