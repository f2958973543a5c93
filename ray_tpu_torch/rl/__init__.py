"""Reinforcement learning on the port: the fused PPO iteration and RLHF."""
