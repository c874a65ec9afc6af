"""Runtime telemetry of the port: ``spans.py`` (the span recorder and
flight recorder), ``memwatch.py`` (device-memory high water),
``pulse.py`` (the live ``/metrics`` ``/healthz`` ``/trace`` plane),
``sight.py`` (the learning-health probes and their detector monitor),
``device_time.py`` (a ``torch.profiler`` trace's device time by named
program, ``obs.program_trace``), and the post-mortem CLIs of
``python -m t2omca_tpu_torch.obs``: ``report.py``, ``timeline.py`` and
``learning.py``, which import no torch."""
