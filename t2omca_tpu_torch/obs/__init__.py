"""Runtime telemetry of the port: ``spans.py`` (the span recorder and
flight recorder), ``memwatch.py`` (device-memory high water),
``pulse.py`` (the live ``/metrics`` ``/healthz`` ``/trace`` plane) and
``sight.py`` (the learning-health probes, their detector monitor and the
``python -m t2omca_tpu_torch.obs learning`` report). Still to port
(``ROADMAP.md`` item 13b): per-program device time
(``obs.program_trace``, ``device_time.py``) and the ``report`` and
``timeline`` CLIs."""
