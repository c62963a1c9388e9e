"""Traffic drivers, one a kind of traffic, each loaded by name from
``benchmark/traffic/<traffic>.py``: ``run(cell)`` runs the cell once and
``control(cell)`` answers with the reference one precision lower."""
