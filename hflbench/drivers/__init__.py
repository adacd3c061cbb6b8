"""Traffic drivers: ``<driver>.py`` holds ``Driver``, named by a traffic
file's ``driver`` key."""
