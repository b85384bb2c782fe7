"""Roofline counts: the least work a kernel's job needs, from the
specification of the work and never from the kernel's source, and the
card's published peaks. ``<kernel>.py`` defines ``work(launches, config)``
returning ``(operations, bytes)`` for the launches a traced run recorded."""
