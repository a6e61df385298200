"""Plain references of the benchmark's configurations, one module a
family; none imports the program."""
