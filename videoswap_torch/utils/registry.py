"""Name -> class registries for the port, separate from the JAX package's
(both register by class name, and the parity tests import both packages in
one process)."""

from __future__ import annotations


class Registry:
    """A key -> object mapping supporting decorator-style registration."""

    def __init__(self, name: str):
        self._name = name
        self._obj_map: dict = {}

    def _do_register(self, name: str, obj, suffix: str | None = None) -> None:
        if isinstance(suffix, str):
            name = name + '_' + suffix
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' was already registered in "
                f"'{self._name}' registry!")
        self._obj_map[name] = obj

    def register(self, obj=None, suffix: str | None = None):
        if obj is None:
            def deco(func_or_class):
                self._do_register(func_or_class.__name__, func_or_class,
                                  suffix)
                return func_or_class
            return deco
        self._do_register(obj.__name__, obj, suffix)
        return obj

    def get(self, name: str, suffix: str = 'videoswap_torch'):
        ret = self._obj_map.get(name)
        if ret is None:
            ret = self._obj_map.get(name + '_' + suffix)
        if ret is None:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry! "
                f'Available: {sorted(self._obj_map)}')
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self):
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()


MODEL_REGISTRY = Registry('model')
PIPELINE_REGISTRY = Registry('pipeline')
DATASET_REGISTRY = Registry('dataset')
TRANSFORM_REGISTRY = Registry('transform')
