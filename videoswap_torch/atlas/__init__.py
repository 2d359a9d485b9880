from .imlp import IMLP, HashEncode, hash_encode, imlp_from_opt, init_imlp, \
    positional_encode
from .trainer import AtlasTrainer

__all__ = ['IMLP', 'HashEncode', 'hash_encode', 'imlp_from_opt', 'init_imlp',
           'positional_encode', 'AtlasTrainer']
