"""Traffic kinds, one module per file (``<kind>.py``), found by the name a
cell's ``traffic`` gives; ``_campaign.py`` is the campaign generator they share."""
