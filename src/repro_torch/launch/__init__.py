"""Runtime pieces shared by the port's serving stack."""
