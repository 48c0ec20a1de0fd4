"""The benchmark's own arithmetic: the operations and bytes a decode step
needs, and the published peaks they are divided by."""
