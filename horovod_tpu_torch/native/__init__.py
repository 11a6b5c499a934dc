"""Native C++ core (``_hvd_core``): the fusion planner, the response
cache, the negotiation decision, the timeline writer and the stall
tracker (counterpart: ``horovod_tpu/native/``; reference: the C++
components of SURVEY.md §2.1).

A host-side CPython extension built from ``core.cpp`` at first use
(``build.py``) and loaded by ``loader.load()``, which ``hvd.init()``
calls when ``HOROVOD_TPU_NATIVE_CORE`` is on.  A failed build raises;
``HOROVOD_TPU_NATIVE_CORE=0`` runs the pure-Python control plane.
"""
