"""RL algorithms (the PPO loss so far)."""
