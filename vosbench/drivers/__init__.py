"""Cell drivers, one module each, named by a traffic mix's `driver` key:
set-up, the measured window and the check of what the window produced."""
