"""Query endpoint, planner, executor, migrator, engines and island shims."""
