"""Model families beside quantum chemistry on the same ANQS/VMC stack."""
