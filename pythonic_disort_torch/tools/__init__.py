"""Small scripts run on the card while working on a kernel."""
