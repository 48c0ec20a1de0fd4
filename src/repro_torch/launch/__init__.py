"""Launchers of the port: the serve and train entry points, the production
mesh descriptions, the analytic sizing and roofline, the dry run and its
report."""
