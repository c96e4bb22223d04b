"""The comparison of a step kind's outputs with the plain reference, one
module a step kind."""
