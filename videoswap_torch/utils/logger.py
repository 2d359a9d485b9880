"""Experiment directories and logging (the port of
videoswap_tpu/utils/logger.py).

`set_path_logger` creates `experiments/<name>` (training) or
`results/<name>` (testing) under the root, archive-renames an existing one
with a timestamp (or, on a resume, keeps it in place), copies the config
file there under a command-line header, records the paths in `opt['path']`
and starts the log file. `MessageLogger` formats the training loop's
`[name][Iter: n/N, lr] [eta, time] loss:` lines. In a multi-process run
only the main process touches the file system; the others get the same
paths and log to the console.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from datetime import datetime

from videoswap_torch.parallel.dist import barrier, is_main_process

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
                    is_train: bool = True,
                    reuse_existing: bool = False) -> dict:
    """Create the experiment directory tree and record its paths in
    `opt['path']` (exp_root, models, visualization, log).

    `reuse_existing` (the train CLI's `--resume`) keeps an existing
    experiment directory in place instead of archive-renaming it: the
    rename would move away the very checkpoint the resume reads.

    Multi-process: only the main process creates, renames and copies (the
    reference gates on `accelerator.is_main_process`); every rank then
    meets the others at a barrier, so none starts before the directory
    exists and none renames another's."""
    name = opt['name']
    exp_root = os.path.join(root_path,
                            'experiments' if is_train else 'results', name)
    main = is_main_process()
    if main and reuse_existing:
        os.makedirs(exp_root, exist_ok=True)
    elif main:
        mkdir_and_rename(exp_root)
    paths = {
        'exp_root': exp_root,
        'models': os.path.join(exp_root, 'models'),
        'visualization': os.path.join(exp_root, 'visualization'),
        'log': os.path.join(exp_root, f'{"train" if is_train else "test"}_'
                            f'{name}_{get_time_str()}.log'),
    }
    if main:
        for k in ('models', 'visualization'):
            os.makedirs(paths[k], exist_ok=True)
        copy_opt_file(config_path, exp_root)
    opt.setdefault('path', {}).update(paths)
    init_logger(paths['log'] if main else None)
    barrier('set_path_logger')
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


class MessageLogger:
    """Formats `[name][Iter: n/N, lr] [eta, time] loss:` lines, those of
    the JAX package's MessageLogger."""

    def __init__(self, opt: dict, start_iter: int = 0):
        self.exp_name = opt['name']
        self.total_iter = opt['train']['total_iter']
        self.start_iter = start_iter
        self.logger = get_logger()
        self.start_time = time.time()

    def __call__(self, log_vars: dict) -> None:
        log_vars = dict(log_vars)
        current_iter = log_vars.pop('iter')
        lrs = log_vars.pop('lrs', [])
        msg = (f'[{self.exp_name[:30]}..][Iter:{current_iter:8,d}/'
               f'{self.total_iter}, lr:(' +
               ', '.join(f'{lr:.3e}' for lr in lrs) + ')] ')
        total_time = time.time() - self.start_time
        done = max(current_iter - self.start_iter, 1)
        time_sec_avg = total_time / done
        eta = time_sec_avg * (self.total_iter - current_iter)
        msg += f'[eta: {int(eta // 3600)}:{int(eta % 3600 // 60):02d}:' \
               f'{int(eta % 60):02d}, time (avg): {time_sec_avg:.3f}] '
        for k, v in log_vars.items():
            msg += f'{k}: {float(v):.4e} '
        self.logger.info(msg)


def reduce_loss_dict(loss_dict: dict) -> dict:
    """Cross-process loss averaging, in one process: the input as it is."""
    return loss_dict
