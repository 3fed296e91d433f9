"""Config validation for the port's builders (the cost-model planner
itself is not ported yet; ROADMAP queue A, engine planes)."""
