"""Launchers of the serving engine: ``serve_crypto`` (mixed-preset
traffic), ``serve_soak`` (the fault-injected soak and its gates) and
``obs_report`` (span-log report, conservation gate, exporter check)."""
