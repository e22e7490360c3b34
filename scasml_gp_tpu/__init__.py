"""Former name of the :mod:`scasml_gp` package, kept so existing imports work.

Importing this package, or any module under it, yields the module objects of
``scasml_gp`` themselves: ``<this package>.gp.solver`` *is*
``scasml_gp.gp.solver``, so both names share one set of modules, classes and
compiled functions.  New code imports ``scasml_gp``.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import scasml_gp

_TARGET = scasml_gp.__name__


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<alias>.<sub>`` to the module ``scasml_gp.<sub>``."""

    def __init__(self, alias: str):
        self.alias = alias
        self._specs = {}

    def _target(self, fullname: str) -> str:
        return _TARGET + fullname[len(self.alias):]

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(self.alias + "."):
            return None
        if importlib.util.find_spec(self._target(fullname)) is None:
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        module = importlib.import_module(self._target(spec.name))
        self._specs[module.__name__] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias's spec on the shared module;
        # give it back its own
        module.__spec__ = self._specs.pop(module.__name__)


if not any(isinstance(f, _AliasFinder) for f in sys.meta_path):
    sys.meta_path.insert(0, _AliasFinder(__name__))
sys.modules[__name__] = scasml_gp
