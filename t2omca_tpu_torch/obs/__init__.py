"""Runtime telemetry of the port (``spans.py``: the span recorder and
flight recorder; ``memwatch.py``: device-memory high water). The JAX
package's learning-health probes (``obs/sight.py``) and live HTTP plane
(``obs/pulse.py``) are not ported yet (``ROADMAP.md`` item 13a)."""
