"""``mx.mod``: the symbolic training API on one context.

``Module`` binds a Symbol with its parameters and optimizer;
``BucketingModule`` keeps one Module per bucket over one set of
parameters; ``SequentialModule`` chains modules, ``PythonModule`` and
``PythonLossModule`` are modules written in Python.
"""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module
from .sequential_module import (PythonLossModule, PythonModule,
                                SequentialModule)

__all__ = ["BaseModule", "BucketingModule", "Module", "PythonLossModule",
           "PythonModule", "SequentialModule"]
