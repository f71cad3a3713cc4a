"""``mx.mod``: the symbolic training API on one context.

``Module`` binds a Symbol with its parameters and optimizer;
``BucketingModule`` keeps one Module per bucket over one set of
parameters.  ``SequentialModule`` and ``PythonModule`` are not ported.
"""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "Module"]
